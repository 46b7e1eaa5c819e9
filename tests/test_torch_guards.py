"""Autograd through the kernel wrappers, and the system's lifecycle, on the
CPU.

A kernel wrapper without a backward kernel raises when autograd would need
one (``build.forbid_grad``): grad mode on and a CUDA input requiring grad.
The card tests hold each wrapper to that (``tests/test_torch_gpu.py``);
here the check itself is held on CPU tensors, and the wrappers' CPU route,
the plain versions, is shown to keep its gradients: the segment sums
against their formula, attention against ``jax.grad`` of the JAX oracle
(float32 rtol 1e-5 / atol 1e-5: a softmax and two products in another
order). ``GLISPSystem`` closes as the reference's does: ``close()`` is
idempotent and the system is a context manager.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.build import forbid_grad  # noqa: E402


def test_forbid_grad_raises_only_when_autograd_needs_a_backward():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(RuntimeError, match="my_kernel: the CUDA kernel has no backward"):
        forbid_grad("my_kernel", y, None, x)
    forbid_grad("my_kernel", y, None)
    forbid_grad("my_kernel", x.detach())
    with torch.no_grad():
        forbid_grad("my_kernel", x)
    with torch.inference_mode():
        forbid_grad("my_kernel", x)


def _segments(m=60, n=9, d=4, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(-1, n + 2, m).astype(np.int32)
    return (torch.as_tensor(rng.standard_normal((m, d)).astype(np.float32)),
            torch.as_tensor(seg), torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32)))


@pytest.mark.parametrize("ragged", [True, False])
def test_segment_sum_keeps_its_gradient_on_cpu(ragged):
    """d/dmsg of sum(w * gnn_aggregate(msg)) is w[seg[e]] on the valid
    edges and 0 on the padding and ids >= n."""
    msg, seg, w = _segments()
    x = msg.clone().requires_grad_(True)
    out = ops.gnn_aggregate(x, seg, w.shape[0], ragged=ragged)
    assert out.grad_fn is not None
    (out * w).sum().backward()
    ok = (seg >= 0) & (seg < w.shape[0])
    want = torch.where(ok[:, None], w[seg.clamp(0, w.shape[0] - 1).long()], 0.0)
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=0, atol=0)


def test_gather_sum_and_count_keep_their_gradients_on_cpu():
    msg, seg, w = _segments(seed=1)
    feats = msg[:20].clone().requires_grad_(True)
    idx = torch.as_tensor(np.random.default_rng(2).integers(-1, 20, 60).astype(np.int32))
    ops.gnn_gather_aggregate(feats, idx, seg, w.shape[0], ragged=False).mul(w).sum().backward()
    ok = (seg >= 0) & (seg < w.shape[0]) & (idx >= 0)
    want = torch.zeros_like(feats).index_add_(
        0, idx[ok].long(), w[seg[ok].long()])
    np.testing.assert_allclose(feats.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    x = msg.clone().requires_grad_(True)
    agg, cnt = ops.gnn_aggregate_and_count(x, seg, w.shape[0])
    assert agg.grad_fn is not None and cnt.grad_fn is None


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_attention_keeps_its_gradient_on_cpu(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32) for _ in range(3))
    g = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    out = ops.mha_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.as_tensor(g)).sum().backward()

    def loss(q, k, v):  # one (batch, head) at a time, as the JAX ops vmap it
        outs = [jax_attention_ref(q[0, :, h], k[0, :, h], v[0, :, h], causal=causal,
                                  window=window) for h in range(2)]
        return (jnp.stack(outs, axis=1)[None] * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_system_closes_and_is_a_context_manager():
    from repro_torch.api import GLISPConfig, GLISPSystem
    from repro_torch.graph import power_law_graph

    g = power_law_graph(400, avg_degree=5, seed=1, feat_dim=8, num_classes=3)
    with GLISPSystem.build(g, GLISPConfig(num_parts=2, fanouts=(4,))) as system:
        assert len(system.sample(np.arange(10)).hops) == 1
    system.close()
    system.close()


def test_close_reaches_a_backend_that_owns_resources():
    from repro_torch.api import GLISPSystem

    closed = []

    class Backend:
        def close(self, timeout):
            closed.append(timeout)

    system = GLISPSystem(graph=None, config=None, plan=None, partitions=[], backend=Backend())
    with system:
        pass
    system.close(timeout=0.5)
    assert closed == [2.0, 0.5]

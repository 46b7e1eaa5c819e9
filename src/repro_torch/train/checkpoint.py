"""Checkpointing: tree of tensors <-> single .npz with slash-joined path keys.

Counterpart of ``repro/train/checkpoint.py`` with the same file layout:
nested dicts and lists flatten to keys such as ``params/layers/0/w`` and
``opt/step``, plus ``__step__``, so a checkpoint written by either package
loads in the other. Lists are encoded as dict keys "<i>" and restored by
the reference-tree structure on load; a restored leaf takes the dtype and
device of the template's tensor.

Saves are atomic (tmp file in the same directory + fsync + ``os.replace``):
a crash mid-save leaves either the previous checkpoint or the new one,
never a truncated file. Structure problems on load (missing/extra keys,
shape mismatches against the template tree) raise :class:`CheckpointError`
with the offending key paths.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["CheckpointError", "save_checkpoint", "load_checkpoint"]


class CheckpointError(RuntimeError):
    """A checkpoint file is missing or does not match the template tree."""


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    elif tree is None:
        return
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree.detach().cpu().numpy()
    else:
        yield prefix[:-1], np.asarray(tree)


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to a bare path; mirror that so save and load
    # agree on the on-disk name regardless of how the caller spelled it
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Atomically write ``tree`` (+ optional ``step``) to ``path``.

    Returns the final on-disk path (``path`` with ``.npz`` appended when
    missing, matching ``np.savez``)."""
    final = _npz_path(path)
    directory = os.path.dirname(final) or "."
    os.makedirs(directory, exist_ok=True)
    flat = dict(_flatten(tree))
    if step is not None:
        flat["__step__"] = np.asarray(step)
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **flat)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    # best-effort directory fsync so the rename itself is durable
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return final


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (a template tree).

    Raises :class:`CheckpointError` when the file is absent or its keys /
    array shapes do not match the template."""
    final = _npz_path(path)
    if not os.path.exists(final):
        raise CheckpointError(f"no checkpoint file at {final}")
    try:
        with np.load(final) as z:
            flat = {k: z[k] for k in z.files}
    except (ValueError, EOFError, OSError) as exc:
        raise CheckpointError(
            f"checkpoint {final} is unreadable (truncated or corrupt): {exc}"
        ) from exc
    step = int(flat.pop("__step__")) if "__step__" in flat else None
    consumed = set()

    def rebuild(template, prefix=""):
        if isinstance(template, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            t = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(template)]
            return type(template)(t) if isinstance(template, tuple) else t
        if template is None:
            return None
        key = prefix[:-1]
        if key not in flat:
            raise CheckpointError(
                f"checkpoint {final} missing key {key!r} — the saved tree "
                "does not match the template structure"
            )
        consumed.add(key)
        arr = flat[key]
        want = getattr(template, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise CheckpointError(
                f"checkpoint {final} shape mismatch at {key!r}: "
                f"saved {tuple(arr.shape)}, template expects {tuple(want)}"
            )
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(arr, dtype=template.dtype, device=template.device)
        return np.asarray(arr, dtype=getattr(template, "dtype", None))

    tree = rebuild(like)
    extra = sorted(set(flat) - consumed)
    if extra:
        raise CheckpointError(
            f"checkpoint {final} holds keys absent from the template "
            f"(structure mismatch): {extra[:5]}"
            + ("..." if len(extra) > 5 else "")
        )
    return tree, step

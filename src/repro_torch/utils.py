"""Small shared host helpers: registries, CSR ranges, byte accounting, hashing.

A copy of the helpers of ``repro/utils.py`` that this package uses, kept
here so that the port imports nothing of the JAX package."""
from __future__ import annotations

from typing import Generic, Iterator, TypeVar

import numpy as np

__all__ = [
    "Registry",
    "nbytes_of",
    "ceil_div",
    "stable_hash64",
    "concat_ranges",
    "csr_slots",
    "incidence_csr",
]

_T = TypeVar("_T")


class Registry(Generic[_T]):
    """Case-insensitive name -> component map with decorator registration.

    Lives here (dependency-free) so both ``repro_torch.api`` and
    ``repro_torch.core`` subsystems can define registries without an import
    cycle."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, _T] = {}

    @staticmethod
    def _key(name: str) -> str:
        return name.strip().lower()

    def register(self, name: str, obj: _T | None = None):
        """``REG.register("name", obj)`` or ``@REG.register("name")``."""
        key = self._key(name)

        def _add(o: _T) -> _T:
            if key in self._entries:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._entries[key] = o
            return o

        return _add if obj is None else _add(obj)

    def get(self, name: str) -> _T:
        key = self._key(name)
        if key not in self._entries:
            known = ", ".join(sorted(self._entries)) or "<none>"
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            )
        return self._entries[key]

    def names(self) -> list[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return self._key(name) in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)


def concat_ranges(lens: np.ndarray) -> np.ndarray:
    """``[0..lens[0]) ++ [0..lens[1]) ++ ...`` as one int64 array."""
    if lens.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lens)
    out = np.arange(ends[-1], dtype=np.int64)
    out -= np.repeat(ends - lens, lens)
    return out


def csr_slots(indptr: np.ndarray, verts: np.ndarray) -> np.ndarray:
    """Concatenated CSR slot ranges of ``verts`` (one repeat + one arange,
    no per-vertex Python)."""
    lens = indptr[verts + 1] - indptr[verts]
    return np.repeat(indptr[verts], lens) + concat_ranges(lens)


def incidence_csr(
    num_vertices: int,
    passes: list[tuple[np.ndarray, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray]:
    """Vertex -> payload CSR built from ``(vertex_array, payload_array)``
    passes, each filled vectorized in vertex-sorted runs.

    The partition subsystem's two uses: undirected edge incidence
    (``passes=[(src, eids), (dst, eids)]`` -> vertex's incident edge ids)
    and undirected neighbor lists (``passes=[(src, dst), (dst, src)]``)."""
    deg = np.zeros(num_vertices, dtype=np.int64)
    for verts, _ in passes:
        deg += np.bincount(verts, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    values = np.empty(indptr[-1], dtype=np.int64)
    fill_ptr = indptr[:-1].copy()
    for verts, payload in passes:
        srt = np.argsort(verts, kind="stable")
        vs = verts[srt]
        ps = payload[srt]
        starts = np.searchsorted(vs, np.arange(num_vertices))
        ends = np.searchsorted(vs, np.arange(num_vertices) + 1)
        lens = ends - starts
        values[np.repeat(fill_ptr, lens) + concat_ranges(lens)] = ps
        fill_ptr = fill_ptr + lens
    return indptr, values


def nbytes_of(obj) -> int:
    """Total nbytes of a (nested) structure of numpy arrays."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(nbytes_of(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return sum(nbytes_of(v) for v in vars(obj).values())
    return 0


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def stable_hash64(x: np.ndarray, salt: int = 0) -> np.ndarray:
    """Deterministic 64-bit mix hash (splitmix64 finalizer), vectorized."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15) * np.uint64(
            salt + 1
        )
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))

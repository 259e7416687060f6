"""A fixed-address slab for one engine's parameter tree (the Python side
of csrc/weight_vmm.cu).

Every decode, mixed and speculative dispatch of the engine is a
CUDA-graph replay captured over the addresses of the weight tensors. The
weight pager (engine/weight_pager.py) frees the weights' device memory
while a model is warm and must bring them back at the same addresses,
or every graph would read freed memory. So the tree lives in one
virtual range reserved through CUDA's virtual-memory API: ``unmap``
releases the physical memory (``torch.cuda.mem_get_info``
shows it free) and ``map`` maps fresh memory at the same addresses. The
tensors of the tree are views of the range, made with ``torch.as_tensor``
over ``__cuda_array_interface__`` (no copy, no PyTorch headers).

The slab owns the dict it is given. Construction moves the tree in leaf
by leaf, replacing each leaf of that dict in place with its view, so the
original leaf can be freed at once: the transient peak is one leaf (and
one granule), not a second tree. Two paging engines take two dicts (a
second engine on the first one's dict would swap the first's leaves).
Leaves that are one tensor (a tied embedding and head, or any alias)
stay one view. The caching allocator does not see the slab: the engine's
HBM ledger registers its mapped bytes as memory outside the allocator.

While the range is unmapped a read of it is an illegal address, which
kills the CUDA context: every path that reads weights passes the pager's
gate first. Nothing maps a dummy page under the range to hide such a
read, and a failed cuMem* call raises (nothing falls back to the caching
allocator).

On the CPU the same class holds one host tensor: ``unmap`` resizes its
storage to nothing and ``map`` back to its size, so the views stay valid
and the state machine above is one code path for both devices. (A read
of a view while unmapped reads freed host memory there: the same fault
as on the card, and the same gate keeps it from happening.)
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any

import torch

from ..ops import _build
from .quant import QTensor

KERNEL = "weight_vmm"
_ALIGN = 256  # bytes: every leaf's offset in the slab
_OOM = 2  # CUDA_ERROR_OUT_OF_MEMORY


def _declare(lib: ctypes.CDLL) -> None:
    u64, u64p, i32 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), \
        ctypes.c_int
    lib.wvmm_granularity.argtypes = [i32, u64p]
    lib.wvmm_reserve.argtypes = [i32, u64, u64p]
    lib.wvmm_map.argtypes = [i32, u64, u64, u64p]
    lib.wvmm_unmap.argtypes = [i32, u64, u64, u64]
    lib.wvmm_free.argtypes = [i32, u64, u64]
    lib.wvmm_error.argtypes = [i32, ctypes.c_char_p, i32]
    lib.wvmm_error.restype = None
    for fn in ("wvmm_granularity", "wvmm_reserve", "wvmm_map",
               "wvmm_unmap", "wvmm_free"):
        getattr(lib, fn).restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(KERNEL, _declare)


def _check(code: int, what: str) -> None:
    if code != 0:
        buf = ctypes.create_string_buffer(128)
        _lib().wvmm_error(code, buf, len(buf))
        raise RuntimeError(f"weight slab: {what} failed: "
                           f"{buf.value.decode()} (CUresult {code})")


class _Range:
    """``__cuda_array_interface__`` of bytes [ptr, ptr + n) of a slab.
    It holds the slab, so the slab outlives every tensor made over it."""

    def __init__(self, slab: "WeightSlab", ptr: int, n: int) -> None:
        self.slab = slab
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def _planes(leaf: Any) -> tuple:
    """The tensors of one parameter leaf (both planes of a QTensor)."""
    return tuple(leaf) if isinstance(leaf, QTensor) else (leaf,)


def _key(t: torch.Tensor) -> tuple:
    """What makes two tensors one: the same bytes seen the same way."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class WeightSlab:
    """One reserved range holding a parameter tree; see the module
    docstring. ``mapped`` says whether memory is behind the range."""

    def __init__(self, params: dict, device: torch.device) -> None:
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._lock = threading.Lock()
        # the size of the distinct planes (aliases of one tensor count
        # once), laid out in tree order; only keys are held, so each
        # original leaf is freed as soon as the dict lets go of it
        seen: set[tuple] = set()
        end = 0
        self.tree_bytes = 0  # the distinct planes' bytes
        for leaf in params.values():
            for t in _planes(leaf):
                if _key(t) not in seen:
                    seen.add(_key(t))
                    end = _round_up(end, _ALIGN) + _nbytes(t)
                    self.tree_bytes += _nbytes(t)
        del seen
        self.granularity = 1
        self._ptr = 0
        self._maps: list[tuple[int, int, int]] = []  # (offset, size, handle)
        self._buf = None  # the CPU slab
        if self.cuda:
            g = ctypes.c_uint64()
            _check(_lib().wvmm_granularity(self._dev, ctypes.byref(g)),
                   "granularity")
            self.granularity = int(g.value)
            self.nbytes = _round_up(max(end, 1), self.granularity)
            ptr = ctypes.c_uint64()
            _check(_lib().wvmm_reserve(self._dev, self.nbytes,
                                       ctypes.byref(ptr)), "reserve")
            self._ptr = int(ptr.value)
        else:
            self.nbytes = end
            self._buf = torch.empty((end,), dtype=torch.uint8)
        self.mapped = True
        self.released = False
        # move the tree in, one plane at a time: on a card each plane's
        # memory is mapped just before its copy, and its original freed
        # (the dict then holds the view) before the next plane,
        # so the device holds one plane beyond the tree at most
        views: dict[tuple, torch.Tensor] = {}
        covered = 0  # bytes of the range with memory behind them
        at = 0
        for name in list(params):
            moved = []
            for t in _planes(params[name]):
                k = _key(t)
                if k not in views:
                    off = _round_up(at, _ALIGN)
                    n = _nbytes(t)
                    if self.cuda and off + n > covered:
                        top = _round_up(off + n, self.granularity)
                        self._map_at(covered, top - covered)
                        covered = top
                    v = self._bytes(off, n).view(t.dtype).view(t.shape)
                    v.copy_(t)
                    views[k] = v
                    at = off + n
                moved.append(views[k])
            params[name] = (QTensor(*moved)
                            if isinstance(params[name], QTensor)
                            else moved[0])
            del t, moved
            if self.cuda:
                # the copy has run before the original's memory goes back
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
        if self.cuda and covered < self.nbytes:
            self._map_at(covered, self.nbytes - covered)

    @property
    def _dev(self) -> int:
        return self.device.index or 0

    def _bytes(self, off: int, n: int) -> torch.Tensor:
        """A uint8 view of bytes [off, off + n) of the slab."""
        if not self.cuda:
            return self._buf[off:off + n]
        return torch.as_tensor(_Range(self, self._ptr + off, n),
                               device=self.device)

    def _map_at(self, off: int, size: int) -> None:
        h = ctypes.c_uint64()
        code = _lib().wvmm_map(self._dev, self._ptr + off, size,
                               ctypes.byref(h))
        if code == _OOM:
            # the caching allocator may hold the memory as free
            # blocks: hand them back and ask once more
            torch.cuda.empty_cache()
            code = _lib().wvmm_map(self._dev, self._ptr + off, size,
                                   ctypes.byref(h))
        _check(code, f"map of {size} bytes")
        self._maps.append((off, size, int(h.value)))

    def mapped_bytes(self) -> int:
        """Device bytes behind the range now (0 on the CPU, unmapped or
        released)."""
        return self.nbytes if self.cuda and self.mapped else 0

    def unmap(self) -> None:
        """Give the memory behind the range back (its contents are lost:
        the caller has copied them out and made sure no work still reads
        them)."""
        with self._lock:
            if not self.mapped or self.released:
                return
            if self.cuda:
                torch.cuda.synchronize(self.device)
                while self._maps:
                    off, size, h = self._maps.pop()
                    _check(_lib().wvmm_unmap(self._dev, self._ptr + off,
                                             size, h), "unmap")
            else:
                self._buf.untyped_storage().resize_(0)
            self.mapped = False

    def map(self) -> None:
        """Fresh memory behind the range, at the same addresses (its
        contents undefined until the caller copies the weights back)."""
        with self._lock:
            if self.released:
                raise RuntimeError("weight slab released")
            if self.mapped:
                return
            if self.cuda:
                self._map_at(0, self.nbytes)
            else:
                self._buf.untyped_storage().resize_(self.nbytes)
            self.mapped = True

    def release(self) -> None:
        """On a card: unmap and give the range back; every view of it is
        dead afterwards. On the CPU: drop the slab's reference to its
        host tensor, which lives on while a view does (idempotent)."""
        if self.released:
            return
        if self.cuda:
            self.unmap()
        with self._lock:
            if self.cuda:
                _check(_lib().wvmm_free(self._dev, self._ptr, self.nbytes),
                       "free")
            self._buf = None
            self.released = True

    def __del__(self) -> None:
        # the last view is gone: nothing can read the range any more
        try:
            self.release()
        except Exception:  # interpreter teardown: the library may be gone
            pass

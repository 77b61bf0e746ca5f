"""Device primitives of the batched Elle cycle engine: the bucket table,
bit packing, and the closure + SCC-label program as CUDA kernels with
their plain PyTorch versions.

The port of the reference's ``jepsen_tpu/elle/ops.py``. A boolean
``[n, n]`` matrix travels as row words (``[n, n/32]``, bit ``j`` of word
``w`` = column ``32w + j``); on the torch side the words are int32 bit
patterns, on the host numpy uint32. Graphs pad to a power-of-two node
bucket from :data:`BUCKETS` and a power-of-two edge pad; padding edges
carry the sacrificial index ``pad`` and add nothing.

:func:`batched_closure` is the reference's ``batched_closure_kernel``
(lines 214-248) for ``nb`` members at once, in three stages, each a
hand-written kernel in ``csrc/elle_closure.cu`` beside a plain version
here:

======================  ====================================================
stage                   what it computes
======================  ====================================================
``adjacency``           zero-fill and edge scatter: ``[nb, pad, pad]`` 0/1
``square``              one step ``A <- min(A + A @ A, 1)``, run
                        ``ceil(log2 pad)`` times (no early exit)
``labels_pack``         ``reach = A > 0`` packed into words, and
                        ``label[i]`` = first ``j`` with mutual reach, or ``i``
======================  ====================================================

A wrapper takes the plain version only for a tensor on the CPU; on a CUDA
tensor it launches its kernel or raises. The kernels hold the matrix in
bf16, the plain versions in float32; both hold 0/1 entries, and every
product is a path count of at most ``pad`` <= 8192, exact in either, so the
two give the same bits. Each wrapper counts its launches in
:data:`LAUNCHES`.

``JEPSEN_ELLE_DEVICE`` (read per call) overrides the engine flag: ``0``
keeps every closure on the host, ``1`` forces the batched engine.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..devices import resolve_device as _torch_device

BUCKETS: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192)
CEILING = BUCKETS[-1]
EDGE_PAD_MIN = 256
WORD_BITS = 32

# Kernel launches per wrapper (the CPU path counts nothing).
LAUNCHES = {name: 0 for name in ("elle_adjacency", "elle_square", "elle_labels_pack")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bucket_for(n: int) -> Optional[int]:
    """The bucket a graph of ``n`` nodes pads to; None above CEILING."""
    for b in BUCKETS:
        if n <= b:
            return b
    return None


def closure_pad(n: int) -> int:
    """Uncapped power-of-two pad (>= 128): SccReach components beyond
    CEILING still need a padded size."""
    return max(BUCKETS[0], 1 << max(0, int(n) - 1).bit_length())


def edge_pad(n_edges: int) -> int:
    return max(EDGE_PAD_MIN, 1 << max(0, int(n_edges) - 1).bit_length())


def closure_steps(pad: int) -> int:
    """Squarings of a closure at ``pad``: ``ceil(log2 pad)``."""
    return max(1, int(np.ceil(np.log2(max(pad, 2)))))


def resolve_device(flag: Optional[bool]) -> Tuple[bool, bool]:
    """(use_device, forced) under the ``JEPSEN_ELLE_DEVICE`` override,
    read per call: ``0`` turns every device path off, ``1`` forces the
    batched engine, whatever the caller passed."""
    env = os.environ.get("JEPSEN_ELLE_DEVICE")
    if env is not None and env.strip() != "":
        on = env.strip().lower() not in ("0", "false", "no", "off")
        return on, on
    if flag is None:
        return True, False
    return bool(flag), bool(flag)


# ---------------------------------------------------------------------------
# Byte model


def packed_words(n: int) -> int:
    return -(-int(n) // WORD_BITS)


def packed_closure_bytes(n: int) -> int:
    """Device-to-host bytes of one bit-packed [pad, pad/32] closure."""
    pad = closure_pad(n)
    return pad * packed_words(pad) * 4


def dense_closure_bytes(n: int, bytes_per_entry: int = 2) -> int:
    """The same closure dense (bf16 by default): 16x the packed form."""
    pad = closure_pad(n)
    return pad * pad * bytes_per_entry


# ---------------------------------------------------------------------------
# Host bit packing


def pack_bits_host(mat: np.ndarray) -> np.ndarray:
    """Bool [n, m] -> uint32 [n, ceil(m/32)] row words."""
    mat = np.asarray(mat, dtype=bool)
    n, m = mat.shape
    mp = packed_words(m) * WORD_BITS
    if mp != m:
        buf = np.zeros((n, mp), dtype=bool)
        buf[:, :m] = mat
        mat = buf
    b = mat.reshape(n, -1, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)


def unpack_bits_host(packed: np.ndarray, m: int) -> np.ndarray:
    """Inverse of :func:`pack_bits_host`: uint32 [n, w] -> bool [n, m]."""
    packed = np.asarray(packed, dtype=np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (packed[:, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(packed.shape[0], -1)[:, :m].astype(bool)


def row_bit(packed_row: np.ndarray, j: int) -> bool:
    """One closure entry from a packed row."""
    return bool((int(packed_row[j >> 5]) >> (j & 31)) & 1)


def pad_edges(srcs, dsts, pad: int, epad: int):
    """Edge arrays padded to ``epad`` with the sacrificial index ``pad``
    (int32)."""
    k = len(srcs)
    s = np.full(epad, pad, np.int32)
    d = np.full(epad, pad, np.int32)
    s[:k] = srcs
    d[:k] = dsts
    return s, d


# ---------------------------------------------------------------------------
# Plain versions (one member's arithmetic, over a batch dimension)


def adjacency_plain(src: torch.Tensor, dst: torch.Tensor, pad: int) -> torch.Tensor:
    """float32 [nb, pad, pad] with 1 at every (src, dst) below ``pad``."""
    nb, epad = src.shape
    a = torch.zeros((nb, pad + 1, pad + 1), dtype=torch.float32, device=src.device)
    member = torch.arange(nb, device=src.device).repeat_interleave(epad)
    s = src.reshape(-1).long().clamp(0, pad)
    d = dst.reshape(-1).long().clamp(0, pad)
    a[member, s, d] = 1.0
    return a[:, :pad, :pad].contiguous()


def square_plain(a: torch.Tensor) -> torch.Tensor:
    """One step ``min(a + a @ a, 1)`` in float32."""
    a = a.float()
    return torch.clamp(a + torch.matmul(a, a), max=1.0)


def labels_pack_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed int32 [nb, pad, pad/32] bit patterns, labels int32 [nb, pad])
    of ``reach = a > 0``."""
    nb, pad, _ = a.shape
    reach = a > 0
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=a.device)
    words = (reach.reshape(nb, pad, pad // WORD_BITS, WORD_BITS).to(torch.int64)
             << shifts).sum(dim=-1)
    packed = torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)
    eye = torch.eye(pad, dtype=torch.bool, device=a.device)
    both = (reach & reach.transpose(1, 2)) | eye
    labels = torch.argmax(both.to(torch.uint8), dim=2).to(torch.int32)
    return packed, labels


# ---------------------------------------------------------------------------
# Kernel wrappers


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(name: str, *args) -> None:
    fn = getattr(_build.load(), name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({_build.error_string(rc)})")
    LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: argument on {t.device}, expected cuda")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _check_pad(pad: int, nb: int) -> None:
    if pad < BUCKETS[0] or pad & (pad - 1):
        raise ValueError(f"pad {pad} is not a power of two >= {BUCKETS[0]}")
    if not 1 <= nb <= 65535:
        raise ValueError(f"batch of {nb} members; the kernels take 1..65535")


def adjacency(src: torch.Tensor, dst: torch.Tensor, pad: int) -> torch.Tensor:
    """Each member's adjacency ``[nb, pad, pad]`` from int32 edge arrays
    ``[nb, epad]`` (padding edges carry ``pad``): bf16 from the kernel,
    float32 from the plain version on the CPU."""
    if src.device.type == "cpu":
        return adjacency_plain(src, dst, pad)
    nb, epad = src.shape
    _check_pad(pad, nb)
    _check("elle_adjacency", src, torch.int32, (nb, epad))
    _check("elle_adjacency", dst, torch.int32, (nb, epad))
    a = torch.empty((nb, pad, pad), dtype=torch.bfloat16, device=src.device)
    _launch("elle_adjacency", _ptr(src), _ptr(dst), _ptr(a), ctypes.c_int(epad),
            ctypes.c_int(pad), ctypes.c_int(nb), _stream())
    return a


def square(a: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One squaring step of every member. The kernel writes into ``out``
    (a bf16 buffer of ``a``'s shape, not ``a`` itself) and returns it."""
    if a.device.type == "cpu":
        return square_plain(a)
    nb, pad, _ = a.shape
    _check_pad(pad, nb)
    _check("elle_square", a, torch.bfloat16, (nb, pad, pad))
    if out is None:
        out = torch.empty_like(a)
    _check("elle_square", out, torch.bfloat16, (nb, pad, pad))
    if out.data_ptr() == a.data_ptr():
        raise ValueError("elle_square: out must be another buffer than a")
    _launch("elle_square", _ptr(a), _ptr(out), ctypes.c_int(pad), ctypes.c_int(nb),
            _stream())
    return out


def labels_pack(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed int32 [nb, pad, pad/32], labels int32 [nb, pad]) of the
    closed matrices ``a``."""
    if a.device.type == "cpu":
        return labels_pack_plain(a)
    nb, pad, _ = a.shape
    _check_pad(pad, nb)
    _check("elle_labels_pack", a, torch.bfloat16, (nb, pad, pad))
    packed = torch.empty((nb, pad, pad // WORD_BITS), dtype=torch.int32, device=a.device)
    labels = torch.empty((nb, pad), dtype=torch.int32, device=a.device)
    _launch("elle_labels_pack", _ptr(a), _ptr(packed), _ptr(labels), ctypes.c_int(pad),
            ctypes.c_int(nb), _stream())
    return packed, labels


def batched_closure(S, D, pad: int, torch_device=None,
                    plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closures and SCC labels of ``nb`` members at bucket ``pad``: the
    port of ``batched_closure_kernel(pad, epad)``. ``S``/``D``: int32
    ``[nb, epad]`` edge arrays (numpy or torch). Returns (packed int32
    ``[nb, pad, pad/32]`` bit patterns, labels int32 ``[nb, pad]``) on the
    torch device: reachability by paths of length >= 1, and ``label[i]`` =
    the first ``j`` with mutual reach (``i`` when none is earlier).
    ``plain`` runs the plain versions on the device (the card's
    comparison)."""
    dev = _torch_device(torch_device)
    src = torch.as_tensor(S, dtype=torch.int32, device=dev).contiguous()
    dst = torch.as_tensor(D, dtype=torch.int32, device=dev).contiguous()
    steps = closure_steps(pad)
    if plain:
        a = adjacency_plain(src, dst, pad)
        for _ in range(steps):
            a = square_plain(a)
        return labels_pack_plain(a)
    a = adjacency(src, dst, pad)
    spare = None
    for _ in range(steps):
        out = square(a, spare)
        spare = a if a.device.type == "cuda" else None
        a = out
    del spare
    return labels_pack(a)


def closure_rows_packed(srcs, dsts, n: int, torch_device=None):
    """One graph's packed closure and SCC labels (the single-member front
    end SccReach uses). Returns (uint32 ``[pad, pad/32]``, int32 ``[pad]``)
    numpy arrays; callers read the rows and bits of their ``n`` nodes."""
    pad = closure_pad(n)
    epad = edge_pad(len(srcs))
    s, d = pad_edges(srcs, dsts, pad, epad)
    packed, labels = batched_closure(s[None], d[None], pad, torch_device)
    return packed[0].cpu().numpy().view(np.uint32), labels[0].cpu().numpy()


def sccs_from_labels(labels: np.ndarray, packed: np.ndarray, n: int) -> list:
    """Nontrivial SCCs (size > 1, or an explicit self-loop) from the
    label array, as sorted node lists."""
    groups: dict = {}
    for i in range(n):
        groups.setdefault(int(labels[i]), []).append(i)
    out = []
    for _lbl, comp in sorted(groups.items()):
        if len(comp) > 1 or row_bit(packed[comp[0]], comp[0]):
            out.append(sorted(comp))
    return out

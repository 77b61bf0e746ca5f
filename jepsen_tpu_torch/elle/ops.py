"""Device primitives of the batched Elle cycle engine: the bucket table,
bit packing, the closure + SCC-label program and the mesh-sharded
closure, as CUDA kernels with their plain PyTorch versions.

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

:func:`sharded_closure` is the reference's ``_sharded_closure_kernel``
(lines 296-357): one graph's closure, block-row sharded over the ``D``
shards of a :class:`jepsen_tpu_torch.parallel.Mesh`, at any pad (no
bucket ceiling). The shards sit on one device, so shard ``d``'s ``P =
pad/D`` rows are rows ``d*P ...`` of one ``[pad, pad]`` buffer, and the
reference's per-step ``all_gather`` is a kernel between buffers:

======================  ====================================================
stage                   what it computes
======================  ====================================================
``unpack``              words ``[r, w]`` -> 0/1 ``[r, m]`` (the entry, and
                        in ``packed`` mode the gathered words each step)
``pack_rows``           ``b > 0`` -> words: the ``packed`` gather and the
                        output
``gather``              the ``dense`` gather: the blocks copied into the
                        full matrix every shard reads
``block_square``        one step ``b <- min(b + b @ full, 1)``
======================  ====================================================

A wrapper takes the plain version only for a tensor on the CPU; on a CUDA
tensor it launches its kernel or raises. The kernels hold the matrix in
bf16 and accumulate products in fp32, the plain versions work in float32;
both hold 0/1 entries, every product entry is a path count of at most
``pad``, exact in fp32 while ``pad < 2**24``, and each step writes 1
where the old entry or the count is nonzero, so the two give the same
bits at every pad. Each wrapper counts its launches in :data:`LAUNCHES`.

``JEPSEN_ELLE_DEVICE`` (read per call) overrides the engine flag: ``0``
keeps every closure on the host, ``1`` forces the batched engine.
``JEPSEN_ELLE_EXCHANGE`` overrides the sharded closure's exchange mode.
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
LAUNCHES = {name: 0 for name in ("elle_adjacency", "elle_square", "elle_labels_pack",
                                 "elle_unpack", "elle_pack_rows", "elle_gather",
                                 "elle_block_square")}
EXCHANGES = ("packed", "dense")


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


def resolve_exchange(mode: Optional[str]) -> str:
    """The sharded closure's exchange mode: ``JEPSEN_ELLE_EXCHANGE`` beats
    the argument, which beats ``"packed"``."""
    env = os.environ.get("JEPSEN_ELLE_EXCHANGE")
    mode = (env or mode or "packed").strip().lower()
    if mode not in EXCHANGES:
        raise ValueError(f"unknown elle exchange mode {mode!r}; expected 'packed' "
                         "or 'dense'")
    return mode


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


def sharded_pad(n: int, n_shards: int) -> int:
    """The sharded closure's pad: a power of two that gives every shard at
    least one word of rows."""
    return max(closure_pad(n), WORD_BITS * int(n_shards))


def shard_exchange_bytes_per_step(n: int, n_devices: int, mode: str = "packed") -> int:
    """Bytes every shard receives per squaring step from the sharded
    closure's gather of the whole matrix: packed words, or dense bf16 (16x
    more)."""
    pad = sharded_pad(n, n_devices)
    if mode == "packed":
        return pad * packed_words(pad) * 4
    if mode == "dense":
        return pad * pad * 2
    raise ValueError(f"unknown exchange mode {mode!r}")


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


def edge_words(srcs, dsts, pad: int) -> np.ndarray:
    """uint32 ``[pad, pad/32]`` row words with bit ``(s, d)`` set for every
    edge: ``pack_bits_host`` of the adjacency, built from the edge list
    without a dense matrix."""
    words = np.zeros((pad, packed_words(pad)), np.uint32)
    s = np.asarray(srcs, np.int64)
    d = np.asarray(dsts, np.int64)
    if s.size:
        np.bitwise_or.at(words, (s, d >> 5), np.left_shift(1, d & 31).astype(np.uint32))
    return words


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


def pack_rows_plain(a: torch.Tensor) -> torch.Tensor:
    """int32 ``[..., r, c/32]`` bit patterns of ``a > 0`` (``c % 32 == 0``)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=a.device)
    bits = (a > 0).reshape(*a.shape[:-1], -1, WORD_BITS).to(torch.int64)
    words = (bits << shifts).sum(dim=-1)
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


def labels_pack_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(packed int32 [nb, pad, pad/32] bit patterns, labels int32 [nb, pad])
    of ``reach = a > 0``."""
    pad = a.shape[-1]
    reach = a > 0
    eye = torch.eye(pad, dtype=torch.bool, device=a.device)
    both = (reach & reach.transpose(1, 2)) | eye
    labels = torch.argmax(both.to(torch.uint8), dim=2).to(torch.int32)
    return pack_rows_plain(a), labels


def unpack_plain(words: torch.Tensor, m: int) -> torch.Tensor:
    """float32 0/1 ``[..., r, m]`` of int32 words ``[..., r, w]``: column ``j``
    is bit ``j % 32`` of word ``j // 32`` (``m <= 32 w``)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    # An arithmetic shift keeps bit j in place; & 1 drops the sign's copies.
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :m].to(torch.float32)


def gather_plain(blocks: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The full matrix gathered from ``n_shards`` contiguous row blocks."""
    return torch.cat(blocks.chunk(n_shards, dim=0), dim=0)


def block_square_plain(b: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """One sharded step ``min(b + b @ full, 1)`` in float32."""
    b = b.float()
    return torch.clamp(b + torch.matmul(b, full.float()), max=1.0)


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


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """The square's TMA loads and stores, and the gather's 16-byte copies,
    need 16-byte-aligned bases (the square's rows, ``pad`` bf16 values, are
    whole 16-byte pieces at every pad; the gather's blocks by its own
    check)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor's data does not start on a 16-byte boundary "
                         "(a view at an offset); the kernel's TMA needs one")


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
    for t in (a, out):
        _check_aligned("elle_square", t)
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


def unpack(words: torch.Tensor, m: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0/1 ``[r, m]`` of int32 words ``[r, w]`` (``m <= 32 w``): bf16 from the
    kernel (into ``out`` when given), float32 from the plain version on the
    CPU."""
    if words.device.type == "cpu":
        return unpack_plain(words, m)
    r, w = words.shape
    if not (1 <= r and 1 <= m <= w * WORD_BITS):
        raise ValueError(f"elle_unpack: {m} columns from {r} rows of {w} words")
    _check("elle_unpack", words, torch.int32, (r, w))
    if out is None:
        out = torch.empty((r, m), dtype=torch.bfloat16, device=words.device)
    _check("elle_unpack", out, torch.bfloat16, (r, m))
    _launch("elle_unpack", _ptr(words), _ptr(out), ctypes.c_int(r), ctypes.c_int(w),
            ctypes.c_int(m), _stream())
    return out


def pack_rows(a: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 words ``[r, c/32]`` of ``a > 0`` for a ``[r, c]`` matrix (``c`` a
    multiple of 32), into ``out`` when given."""
    if a.device.type == "cpu":
        return pack_rows_plain(a)
    r, c = a.shape
    if r < 1 or c < WORD_BITS or c % WORD_BITS:
        raise ValueError(f"elle_pack_rows: a [{r}, {c}] matrix; columns must be a "
                         f"positive multiple of {WORD_BITS}")
    _check("elle_pack_rows", a, torch.bfloat16, (r, c))
    if out is None:
        out = torch.empty((r, c // WORD_BITS), dtype=torch.int32, device=a.device)
    _check("elle_pack_rows", out, torch.int32, (r, c // WORD_BITS))
    _launch("elle_pack_rows", _ptr(a), _ptr(out), ctypes.c_int(r), ctypes.c_int(c), _stream())
    return out


def gather(blocks: torch.Tensor, n_shards: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``dense`` exchange: the full ``[r, c]`` matrix every shard reads,
    gathered from the ``n_shards`` contiguous row blocks of ``blocks``,
    into ``out`` (another buffer) when given. On one device the blocks are
    one contiguous range: the kernel is one 16-byte-wide copy of it, and
    both bases must be 16-byte aligned."""
    if blocks.device.type == "cpu":
        return gather_plain(blocks, n_shards)
    r, c = blocks.shape
    if n_shards < 1 or r % n_shards or (r // n_shards * c) % 8:
        raise ValueError(f"elle_gather: [{r}, {c}] blocks do not split into {n_shards} "
                         "shards of whole 16-byte rows")
    _check("elle_gather", blocks, torch.bfloat16, (r, c))
    if out is None:
        out = torch.empty_like(blocks)
    _check("elle_gather", out, torch.bfloat16, (r, c))
    if out.data_ptr() == blocks.data_ptr():
        raise ValueError("elle_gather: out must be another buffer than blocks")
    for t in (blocks, out):
        _check_aligned("elle_gather", t)
    _launch("elle_gather", _ptr(blocks), _ptr(out), ctypes.c_int(r), ctypes.c_int(c),
            ctypes.c_int(n_shards), _stream())
    return out


def block_square(b: torch.Tensor, full: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sharded step ``min(b + b @ full, 1)`` of every shard's block rows
    (``b`` and ``full`` ``[pad, pad]``), into ``out`` (a third buffer) when
    given."""
    if b.device.type == "cpu":
        return block_square_plain(b, full)
    pad = b.shape[0]
    _check_pad(pad, 1)
    _check("elle_block_square", b, torch.bfloat16, (pad, pad))
    _check("elle_block_square", full, torch.bfloat16, (pad, pad))
    if out is None:
        out = torch.empty_like(b)
    _check("elle_block_square", out, torch.bfloat16, (pad, pad))
    if out.data_ptr() in (b.data_ptr(), full.data_ptr()):
        raise ValueError("elle_block_square: out must be another buffer than b and full")
    for t in (b, full, out):
        _check_aligned("elle_block_square", t)
    _launch("elle_block_square", _ptr(b), _ptr(full), _ptr(out), ctypes.c_int(pad),
            _stream())
    return out


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


# ---------------------------------------------------------------------------
# Mesh-sharded closure


def sharded_closure_words(words: torch.Tensor, n_shards: int, exchange: str = "packed",
                          plain: bool = False) -> torch.Tensor:
    """The closure of the graph whose adjacency rows are ``words`` (int32
    ``[pad, pad/32]`` on the device), block-row sharded over ``n_shards``
    shards of that device, packed the same way. Each of the ``ceil(log2
    pad)`` steps gathers the whole matrix (``packed``: pack and unpack;
    ``dense``: a copy of the blocks), then squares every shard's rows
    against it. ``plain`` runs the plain versions on the device."""
    pad = words.shape[0]
    steps = closure_steps(pad)
    if plain:
        b = unpack_plain(words, pad)
        for _ in range(steps):
            full = unpack_plain(pack_rows_plain(b), pad) if exchange == "packed" \
                else gather_plain(b, n_shards)
            b = block_square_plain(b, full)
        return pack_rows_plain(b)
    b = unpack(words, pad)
    wbuf = full = spare = None
    if b.device.type == "cuda":
        wbuf, full, spare = torch.empty_like(words), torch.empty_like(b), torch.empty_like(b)
    for _ in range(steps):
        if exchange == "packed":
            wbuf = pack_rows(b, wbuf)
            full = unpack(wbuf, pad, full)
        else:
            full = gather(b, n_shards, full)
        b, spare = block_square(b, full, spare), b
    del spare, full
    return pack_rows(b, wbuf)


def sharded_closure(srcs, dsts, n: int, mesh, exchange: Optional[str] = None) -> np.ndarray:
    """One graph's closure, block-row sharded over the leading axis of
    ``mesh`` (a power of two ``D``) on ``mesh.device``: the port of the
    reference's ``sharded_closure``. The host builds the packed adjacency
    rows from the edge list; the result is the uint32 ``[pad, pad/32]``
    closure (paths of length >= 1) at ``pad = max(closure_pad(n), 32 D)``,
    with no bucket ceiling and no labels."""
    exchange = resolve_exchange(exchange)
    D = int(mesh.shape[mesh.axis_names[0]])
    if D & (D - 1):
        raise ValueError(f"sharded closure needs a power-of-two mesh axis, got {D}")
    pad = sharded_pad(n, D)
    words = torch.from_numpy(edge_words(srcs, dsts, pad).view(np.int32)).to(mesh.device)
    out = sharded_closure_words(words, D, exchange)
    return out.cpu().numpy().view(np.uint32)

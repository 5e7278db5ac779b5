"""LARS weight update (paper Figs. 5 and 6): the CUDA kernels' wrappers and
the plain PyTorch versions.

The kernels (``csrc/lars.cu``) replace the two TPU kernels of
``repro/kernels/lars.py``, the weight-update hot spot of MLPerf ResNet-50:
``_norms_kernel`` (``pallas_call`` at line 62), the per-block fp32 partial
sums of w^2 and g^2, and ``_update_kernel`` (``pallas_call`` at line 80),
the elementwise momentum and trust-scaled update. What bounds both on an
H100 is bytes: 8 B an element read for the norms, 12 B read and 8 B
written for the update. Each kernel takes up to ``MAX_LEAVES`` leaves in
one launch, as the TPU kernel passes once over the flattened parameter
buffer; the leaf table travels by value. The norms kernel cuts each leaf
into chunks by :func:`norm_chunk` (a function of n alone) and writes each
chunk's (sum w^2, sum g^2) pair to its own row (a fixed order, no atomics,
so a leaf's pairs are bitwise the same alone, beside other leaves, and on
a rerun). The update kernel cuts each leaf into tiles of ``UPDATE_TILE``
elements; a block sums a leaf's rows in one fixed order the first time it
meets the leaf, applies the trust rule, reads lr from device memory and
writes w and m in place, so the optimizer step never reads a norm, the
trust or lr on the host, and a leaf's w' and m' are bitwise those of its
one-leaf launch.

:func:`lars_norms_multi_cuda` launches the norms kernel over many leaves
(one launch a step for ResNet-50's 54), :func:`lars_norms_cuda` over one;
:func:`lars_apply_multi_cuda` launches the update kernel over many leaves
(one launch a step too), :func:`lars_apply_cuda` over one, and
:func:`lars_update_cuda` both for one leaf; all take contiguous fp32 CUDA
tensors and raise on anything else. :func:`lars_update_torch` is the plain
version (``repro/kernels/ref.py:117-140``) and :func:`lars_partials_torch`
the plain version of the norms kernel's output; the CPU path and the
on-card comparison use them.
"""
from __future__ import annotations

import ctypes

import torch

THREADS = 256           # csrc/lars.cu kThreads
MAX_NORM_BLOCKS = 264   # csrc/lars.cu kMaxNormBlocks: partial pairs a leaf
MAX_LEAVES = 64         # csrc/lars.cu kMaxLeaves: leaves a launch
MIN_CHUNK = 4096        # elements: a norms chunk is at least this long ...
CHUNK_ALIGN = 1024      # ... and a multiple of this
UPDATE_TILE = 4096      # csrc/lars.cu kTile: elements an update work item


def lars_trust_torch(w, g, *, weight_decay, eta, eps=1e-9):
    """The trust ratio of ``repro/kernels/ref.py:126-130``, an fp32 0-d
    tensor: ``eta*||w|| / (||g|| + wd*||w|| + eps)`` when both norms are
    > 0, else exactly 1."""
    w_norm = torch.linalg.vector_norm(w.float())
    g_norm = torch.linalg.vector_norm(g.float())
    return torch.where(
        (w_norm > 0) & (g_norm > 0),
        eta * w_norm / (g_norm + weight_decay * w_norm + eps),
        torch.ones((), dtype=torch.float32, device=w_norm.device))


def lars_apply_torch(w, g, m, trust, *, lr, weight_decay, momentum,
                     scaled_momentum=True):
    """The elementwise update of ``repro/kernels/ref.py:131-140`` given the
    trust: returns new (w', m') in fp32."""
    w32, g32, m32 = w.float(), g.float(), m.float()
    update = g32 + weight_decay * w32
    if scaled_momentum:  # Fig. 5: v = mu*v + (g + wd*w); w -= lr*trust*v
        new_m = momentum * m32 + update
        new_w = w32 - lr * trust * new_m
    else:                # Fig. 6: v = mu*v + lr*trust*(g + wd*w); w -= v
        new_m = momentum * m32 + lr * trust * update
        new_w = w32 - new_m
    return new_w, new_m


def lars_update_torch(w, g, m, *, lr, weight_decay, momentum, eta, eps=1e-9,
                      scaled_momentum=True):
    """``repro.kernels.ref.lars_update``: all math in fp32; ``lr`` a float
    or an fp32 0-d tensor. Returns new (w' in w's dtype, m' in m's
    dtype); the inputs are not changed."""
    trust = lars_trust_torch(w, g, weight_decay=weight_decay, eta=eta,
                             eps=eps)
    new_w, new_m = lars_apply_torch(
        w, g, m, trust, lr=lr, weight_decay=weight_decay, momentum=momentum,
        scaled_momentum=scaled_momentum)
    return new_w.to(w.dtype), new_m.to(m.dtype)


def norm_chunk(n: int) -> int:
    """The norms kernel's chunk length for a leaf of n elements: at least
    ``MIN_CHUNK``, a multiple of ``CHUNK_ALIGN``, and long enough that the
    leaf has at most ``MAX_NORM_BLOCKS`` chunks. A function of n alone, so
    a leaf's partial sums do not depend on the leaves launched beside it."""
    want = max(MIN_CHUNK, -(-n // MAX_NORM_BLOCKS))
    return -(-want // CHUNK_ALIGN) * CHUNK_ALIGN


def norm_blocks(n: int) -> int:
    """The number of partial pairs (chunks) of a leaf of n elements, at
    least 1 and at most ``MAX_NORM_BLOCKS``."""
    return max(1, -(-n // norm_chunk(n)))


def chunk_plan(ns):
    """Row ranges of the leaves' partial pairs in one (total, 2) output:
    for leaf sizes ``ns``, a list of (first row, rows, chunk length), the
    first rows cumulative."""
    plan, first = [], 0
    for n in ns:
        k = norm_blocks(n)
        plan.append((first, k, norm_chunk(n)))
        first += k
    return plan


class _NormLeaf(ctypes.Structure):
    """``csrc/lars.cu`` ``NormLeaf``: field for field, 32 bytes."""
    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("first", ctypes.c_int),
                ("chunk", ctypes.c_int)]


def leaf_tables(w_ptrs, g_ptrs, ns):
    """The norms launches for leaves at device addresses ``w_ptrs`` and
    ``g_ptrs`` of sizes ``ns`` (each > 0): a list of (ctypes array of
    ``_NormLeaf``, first output row, rows), at most ``MAX_LEAVES`` leaves a
    launch, each leaf's ``first`` counted from its launch's first row."""
    plan = chunk_plan(ns)
    launches = []
    for s in range(0, len(ns), MAX_LEAVES):
        idx = range(s, min(s + MAX_LEAVES, len(ns)))
        row0 = plan[s][0]
        table = (_NormLeaf * len(idx))(*(
            _NormLeaf(w_ptrs[i], g_ptrs[i], ns[i], plan[i][0] - row0,
                      plan[i][2]) for i in idx))
        last = plan[idx[-1]]
        launches.append((table, row0, last[0] + last[1] - row0))
    return launches


class _UpdateLeaf(ctypes.Structure):
    """``csrc/lars.cu`` ``UpdateLeaf``: field for field, 48 bytes."""
    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("parts", ctypes.c_int),
                ("first", ctypes.c_int)]


def update_tiles(n: int) -> int:
    """The update kernel's work items for a leaf of n elements: tiles of
    ``UPDATE_TILE`` elements, the last one short."""
    return -(-n // UPDATE_TILE)


def update_tables(w_ptrs, g_ptrs, m_ptrs, part_ptrs, parts, ns):
    """The update launches for leaves at device addresses ``w_ptrs``,
    ``g_ptrs``, ``m_ptrs`` of sizes ``ns`` (each > 0), each with ``parts``
    rows of the norms output at ``part_ptrs``: a list of (ctypes array of
    ``_UpdateLeaf``, index of its first leaf), at most ``MAX_LEAVES``
    leaves a launch, each leaf's ``first`` tile counted from its launch's
    start."""
    launches = []
    for s in range(0, len(ns), MAX_LEAVES):
        rows, first = [], 0
        for i in range(s, min(s + MAX_LEAVES, len(ns))):
            rows.append(_UpdateLeaf(w_ptrs[i], g_ptrs[i], m_ptrs[i],
                                    part_ptrs[i], ns[i], parts[i], first))
            first += update_tiles(ns[i])
        launches.append(((_UpdateLeaf * len(rows))(*rows), s))
    return launches


def lars_partials_torch(w, g):
    """The norms kernel's output for one leaf, plain: (norm_blocks(n), 2)
    fp32 sums of w^2 and g^2 over each chunk of ``norm_chunk(n)``
    elements (summed in another order than the kernel's)."""
    n = w.numel()
    k, chunk = norm_blocks(n), norm_chunk(n)
    out = []
    for t in (w, g):
        flat = t.reshape(-1).float()
        flat = torch.cat([flat, flat.new_zeros(k * chunk - n)])
        out.append(flat.reshape(k, chunk).square().sum(1))
    return torch.stack(out, dim=1)


def _check(name, tensors, dev=None):
    """Every tensor an fp32, contiguous CUDA tensor on one device, all of
    one shape; returns that device."""
    dev = dev or tensors[0][1].device
    shape = tensors[0][1].shape
    for label, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}; every input "
                             f"must be a CUDA tensor on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} is {t.dtype}; the kernel takes "
                            f"torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
        if t.shape != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
    return dev


def _device_scalar(name, x, dev):
    """``x`` (a float or a one-element fp32 tensor on ``dev``) as a
    one-element fp32 tensor on ``dev``, without a host round trip."""
    if not isinstance(x, torch.Tensor):
        return torch.full((), float(x), dtype=torch.float32, device=dev)
    if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
        raise ValueError(f"{name}: lr must be a float or a one-element fp32 "
                         f"tensor on {dev}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    return x.contiguous()


def _norms_launch(name, ws, gs, dev):
    """Launch the norms kernel over leaves ``ws``/``gs`` (checked, each
    > 0 elements). Returns the (total, 2) output and the kernel launches
    made."""
    ns = [w.numel() for w in ws]
    tables = leaf_tables([w.data_ptr() for w in ws],
                         [g.data_ptr() for g in gs], ns)
    total = sum(rows for _, _, rows in tables)
    partial = torch.empty((total, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    for table, row0, _ in tables:
        err = lib.lars_norms(ctypes.addressof(table), len(table),
                             partial[row0:].data_ptr(), stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return partial, len(tables)


def lars_norms_cuda(w, g):
    """Launch the norms kernel on one leaf: returns the (norm_blocks(n), 2)
    fp32 partial sums of w^2 and g^2 (one pair a chunk). Counts each launch
    in ``lars_norms_cuda.launches``."""
    name = "lars_norms_cuda"
    dev = _check(name, (("w", w), ("g", g)))
    if w.numel() == 0:
        return torch.zeros((1, 2), dtype=torch.float32, device=dev)
    partial, n = _norms_launch(name, [w], [g], dev)
    lars_norms_cuda.launches += n
    return partial


lars_norms_cuda.launches = 0


def lars_norms_multi_cuda(ws, gs):
    """Launch the norms kernel over many leaves at once: ``ws[i]`` and
    ``gs[i]`` contiguous fp32 CUDA tensors of one shape and at least one
    element, all on one device. Returns (the (total, 2) fp32 partial sums,
    one row a chunk, leaves in order; and each leaf's row slice of it, the
    ``partial`` that :func:`lars_apply_cuda` takes). One kernel launch for
    every ``MAX_LEAVES`` leaves, each counted in
    ``lars_norms_multi_cuda.launches``; leaf i's rows equal
    ``lars_norms_cuda(ws[i], gs[i])`` bit for bit."""
    name = "lars_norms_multi_cuda"
    if len(ws) != len(gs) or not ws:
        raise ValueError(f"{name}: needs as many gradients as weights, and "
                         f"at least one leaf; got {len(ws)} and {len(gs)}")
    dev = ws[0].device
    for i, (w, g) in enumerate(zip(ws, gs)):
        _check(name, ((f"ws[{i}]", w), (f"gs[{i}]", g)), dev)
        if w.numel() == 0:
            raise ValueError(f"{name}: ws[{i}] has no elements")
    partial, n = _norms_launch(name, ws, gs, dev)
    lars_norms_multi_cuda.launches += n
    plan = chunk_plan([w.numel() for w in ws])
    return partial, [partial[first:first + k] for first, k, _ in plan]


lars_norms_multi_cuda.launches = 0


def _check_partial(name, label, partial, dev):
    _check(name, ((label, partial),), dev)
    if partial.dim() != 2 or partial.shape[1] != 2 or not (
            1 <= partial.shape[0] <= MAX_NORM_BLOCKS):
        raise ValueError(f"{name}: {label} must be (k, 2) with 1 <= k <= "
                         f"{MAX_NORM_BLOCKS}, got {tuple(partial.shape)}")


def _apply_launch(name, ws, gs, ms, parts, lr, trust_out, dev, *,
                  weight_decay, momentum, eta, eps, scaled_momentum):
    """Launch the update kernel over checked leaves of > 0 elements, one
    launch every ``MAX_LEAVES`` leaves; returns the launches made."""
    tables = update_tables([w.data_ptr() for w in ws],
                           [g.data_ptr() for g in gs],
                           [m.data_ptr() for m in ms],
                           [p.data_ptr() for p in parts],
                           [p.shape[0] for p in parts],
                           [w.numel() for w in ws])
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    for table, s in tables:
        err = lib.lars_update(
            ctypes.addressof(table), len(table), lr.data_ptr(),
            trust_out[s:].data_ptr() if trust_out is not None else None,
            weight_decay, momentum, eta, eps, int(bool(scaled_momentum)),
            stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
    return len(tables)


def _check_disjoint(name, ws, gs, ms):
    """No two leaves write the same memory, and no leaf reads a gradient
    another leaf (or itself) writes."""
    written = [t.data_ptr() for t in (*ws, *ms)]
    seen = set(written)
    if len(seen) != len(written) or any(g.data_ptr() in seen for g in gs):
        raise ValueError(f"{name}: w, g and m must not share memory, within "
                         f"a leaf or across leaves")


def lars_apply_multi_cuda(ws, gs, ms, parts, *, lr, weight_decay, momentum,
                          eta, eps=1e-9, scaled_momentum=True,
                          trust_out=None):
    """Launch the update kernel over many leaves at once: ``ws[i]``,
    ``gs[i]``, ``ms[i]`` contiguous fp32 CUDA tensors of one shape and at
    least one element, all on one device, w and m updated in place;
    ``parts[i]`` leaf i's (k, 2) rows of the norms output (the slices
    :func:`lars_norms_multi_cuda` returns), 1 <= k <= ``MAX_NORM_BLOCKS``.
    ``lr`` a float or a one-element fp32 CUDA tensor (read on the card);
    ``trust_out``, if given, an (n_leaves,) fp32 CUDA tensor the trusts are
    written to. Returns (ws, ms). One kernel launch for every
    ``MAX_LEAVES`` leaves, each counted in
    ``lars_apply_multi_cuda.launches``; leaf i's w' and m' equal
    :func:`lars_apply_cuda` on it alone bit for bit."""
    name = "lars_apply_multi_cuda"
    if not (len(ws) == len(gs) == len(ms) == len(parts)) or not ws:
        raise ValueError(f"{name}: needs one gradient, momentum and partial "
                         f"a weight, and at least one leaf; got {len(ws)}, "
                         f"{len(gs)}, {len(ms)} and {len(parts)}")
    dev = ws[0].device
    for i, (w, g, m, p) in enumerate(zip(ws, gs, ms, parts)):
        _check(name, ((f"ws[{i}]", w), (f"gs[{i}]", g), (f"ms[{i}]", m)), dev)
        _check_partial(name, f"parts[{i}]", p, dev)
        if w.numel() == 0:
            raise ValueError(f"{name}: ws[{i}] has no elements")
    _check_disjoint(name, ws, gs, ms)
    lr = _device_scalar(name, lr, dev)
    if trust_out is not None:
        _check(name, (("trust_out", trust_out),), dev)
        if trust_out.shape != (len(ws),):
            raise ValueError(f"{name}: trust_out must be ({len(ws)},), got "
                             f"{tuple(trust_out.shape)}")
    lars_apply_multi_cuda.launches += _apply_launch(
        name, ws, gs, ms, parts, lr, trust_out, dev,
        weight_decay=weight_decay, momentum=momentum, eta=eta, eps=eps,
        scaled_momentum=scaled_momentum)
    return ws, ms


lars_apply_multi_cuda.launches = 0


def lars_apply_cuda(w, g, m, partial, *, lr, weight_decay, momentum, eta,
                    eps=1e-9, scaled_momentum=True, trust_out=None):
    """Launch the update kernel on one leaf, from the partial sums of
    :func:`lars_norms_cuda`: the trust, then w and m updated in place.
    ``lr`` a float or a one-element fp32 CUDA tensor (read on the card);
    ``trust_out``, if given, a one-element fp32 CUDA tensor the kernel
    writes the trust to. Returns (w, m). Counts each launch in
    ``lars_apply_cuda.launches``."""
    name = "lars_apply_cuda"
    dev = _check(name, (("w", w), ("g", g), ("m", m)))
    _check_partial(name, "partial", partial, dev)
    if w.numel():
        _check_disjoint(name, [w], [g], [m])
    lr = _device_scalar(name, lr, dev)
    if trust_out is not None:
        _check(name, (("trust_out", trust_out),), dev)
        if trust_out.numel() != 1:
            raise ValueError(f"{name}: trust_out must hold one value")
    if w.numel() == 0:
        return w, m
    lars_apply_cuda.launches += _apply_launch(
        name, [w], [g], [m], [partial], lr,
        trust_out.reshape(1) if trust_out is not None else None, dev,
        weight_decay=weight_decay, momentum=momentum, eta=eta, eps=eps,
        scaled_momentum=scaled_momentum)
    return w, m


lars_apply_cuda.launches = 0


def lars_update_cuda(w, g, m, *, lr, weight_decay, momentum, eta, eps=1e-9,
                     scaled_momentum=True, trust_out=None):
    """:func:`lars_update_torch` through the two kernels, in place: w, g
    and m contiguous fp32 CUDA tensors of one shape, ``lr`` a float or a
    one-element fp32 CUDA tensor. Writes w' and m' into w and m and
    returns them. Launches on the current stream and does not
    synchronise."""
    partial = lars_norms_cuda(w, g)
    return lars_apply_cuda(w, g, m, partial, lr=lr,
                           weight_decay=weight_decay, momentum=momentum,
                           eta=eta, eps=eps, scaled_momentum=scaled_momentum,
                           trust_out=trust_out)


def reset_launches() -> None:
    lars_norms_cuda.launches = 0
    lars_norms_multi_cuda.launches = 0
    lars_apply_cuda.launches = 0
    lars_apply_multi_cuda.launches = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("lars")
    if lib.lars_norms.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lars_norms.argtypes = [p, i, p, p]
        lib.lars_norms.restype = i
        lib.lars_update.argtypes = [p, i, p, p, f, f, f, f, i, p]
        lib.lars_update.restype = i
    return lib

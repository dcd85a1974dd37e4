"""Linear recurrences (counterpart of convopeq_tpu/ops/scan_iir.py).

`affine_scan_2x2` in its matmul form (convopeq_tpu/ops/scan_iir.py:
107-222): within a chunk the solution of s[n+1] = A s[n] + bu[n] is a
strictly lower-triangular block-Toeplitz product; the chunk-boundary
states follow from the chunk totals (A^chunk, v_c) by an associative
scan.  `associative_scan` is jax.lax.associative_scan's tree (pairs
combined, the half-length scan by recursion, the even elements from the
odd ones), log depth, no Python loop over the elements: the same
composition order as the JAX package, so that the f64 results agree
where the recurrence is ill-conditioned (the 2x2 companion form of the
18-20 Hz output-filter biquads carries ~6e-11 of rounding in either
package, their trees equal or not).

The biquads of the staged chain (JAX :61-104, :286-565):
`biquad_df2t_scan` with its routes `fir` (`_biquad_fir_f32`, a 128-tap
banded-Toeplitz product), `diag` (`_biquad_scan_diag`: pole partial
fractions through `_complex_one_pole`, or two real one-poles) and `2x2`
(`_biquad_scan_2x2`, the companion matrix through `affine_scan_2x2`),
and `one_pole_scan` (associative scans in chunks of 4096, as the JAX
package).  `_complex_one_pole` is the Toeplitz-in-chunk form with a
complex pole, in complex tensors (the JAX package's split real and
imaginary parts worked around the TPU).  The "auto" rule
(`biquad_route`): f32 scalar-coefficient biquads go to `diag` above pole
radius POLE_RADIUS_DIAG_F32 and to `fir` at or below POLE_RADIUS_FIR_F32
(zero initial state); everything else, and every f64 biquad (the JAX
package's CPU rule), to `2x2`.  The JAX package's f64 accelerator branch
(:329-339) works around the TPU's emulated f64 and is not ported; nor
are its VPU affine-scan backend and CONVOPEQ_AFFINE_BACKEND.

Time is the last axis of a signal (..., N), the second-to-last of `bu`
(..., N, 2); leading axes are batch.  Matmuls run in the tensors' type
(no TF32: `device.resolve_device` turns it off on the card).  The
constants made on the host (the in-chunk Toeplitz index and mask, a
scalar biquad's companion matrix) are copied to the device once
(`utils/dsputil.device_constants`): a copy from pageable host memory
waits for the card's queue to drain, and the streaming step
(runtime/streaming.py) runs these scans every block.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..utils.dsputil import device_constants

MATMUL_CHUNK = 128
DEFAULT_CHUNK = 4096

# Pole radius above which an f32 biquad takes the diagonalized scan: the
# companion matrix's prefix products grow like k r^k (up to ~1/(e (1-r)))
# before they cancel (JAX :46-50).
POLE_RADIUS_DIAG_F32 = 0.99
# Pole radius at or below which an f32 biquad runs as a truncated FIR of
# BIQUAD_FIR_TAPS taps: the truncation error r^taps < 1e-9 at 0.85.
POLE_RADIUS_FIR_F32 = 0.85
BIQUAD_FIR_TAPS = 128

_SCAN_CONSTANTS: OrderedDict = OrderedDict()
# affine_scan_2x2's operands by key (each T is (2 chunk)^2 values: 0.5 MB
# in f64 at chunk 128)
_SCAN_OPERANDS: OrderedDict = OrderedDict()
SCAN_OPERANDS_KEPT = 128


def _biquad_pole_radius(a1: float, a2: float) -> float:
    """Largest pole magnitude of z^2 + a1 z + a2."""
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        return float(np.sqrt(max(a2, 0.0)))
    s = np.sqrt(disc)
    return float(max(abs((-a1 + s) / 2.0), abs((-a1 - s) / 2.0)))


def associative_scan(combine, elems):
    """Inclusive scan of the tuple of tensors `elems` along their last
    axis under the associative `combine(left, right)`, in the tree of
    jax.lax.associative_scan."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    reduced = combine(tuple(e[..., 0:-1:2] for e in elems),
                      tuple(e[..., 1::2] for e in elems))
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[..., :-1] for e in odd),
                       tuple(e[..., 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[..., 2::2] for e in elems))
    return _interleave(elems, even, odd, n)


def _interleave(elems, even, odd, n: int):
    """The scan's outputs at even positions (the first element, then
    `even`) and odd positions (`odd`), n along the last axis."""
    out = []
    for e, ev, od in zip(elems, even, odd):
        ev = torch.cat([e[..., :1].expand(ev.shape[:-1] + (1,)), ev], dim=-1)
        res = ev.new_empty(ev.shape[:-1] + (n,))
        res[..., 0::2] = ev
        res[..., 1::2] = od
        out.append(res)
    return tuple(out)


def _affine_combine(left, right):
    """right o left for affine maps x -> M x + v, elementwise, each as
    (m11, m12, m21, m22, v1, v2)."""
    l11, l12, l21, l22, lv1, lv2 = left
    r11, r12, r21, r22, rv1, rv2 = right
    return (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
            r21 * l11 + r22 * l21, r21 * l12 + r22 * l22,
            r11 * lv1 + r12 * lv2 + rv1, r21 * lv1 + r22 * lv2 + rv2)


def _matrix_combine(left, right):
    """The matrix half of `_affine_combine`: right o left of the maps'
    matrices (m11, m12, m21, m22)."""
    l11, l12, l21, l22 = left
    r11, r12, r21, r22 = right
    return (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
            r21 * l11 + r22 * l21, r21 * l12 + r22 * l22)


def _vector_combine(rm, left, right):
    """The vector half of `_affine_combine`: (v1, v2) of right o left,
    given the right maps' matrices rm."""
    r11, r12, r21, r22 = rm
    lv1, lv2 = left
    rv1, rv2 = right
    return (r11 * lv1 + r12 * lv2 + rv1, r21 * lv1 + r22 * lv2 + rv2)


def _matrix_tree(me):
    """The maps' matrices at each level of `associative_scan`'s tree:
    level 0 `me`, level k+1 the pairs of level k combined."""
    levels = [me]
    while levels[-1][0].shape[-1] >= 2:
        m = levels[-1]
        levels.append(_matrix_combine(tuple(e[..., 0:-1:2] for e in m),
                                      tuple(e[..., 1::2] for e in m)))
    return levels


def _affine_vector_scan(levels, v, depth: int = 0):
    """The vector half of associative_scan(_affine_combine, m + v), the
    matrices' tree `levels` (`_matrix_tree` of m) made beforehand: the
    same operations on v in the same order, so the same roundings."""
    n = v[0].shape[-1]
    if n < 2:
        return v
    m = levels[depth]
    reduced = _vector_combine(tuple(e[..., 1::2] for e in m),
                              tuple(e[..., 0:-1:2] for e in v),
                              tuple(e[..., 1::2] for e in v))
    odd = _affine_vector_scan(levels, reduced, depth + 1)
    left = tuple(e[..., :-1] for e in odd) if n % 2 == 0 else odd
    even = _vector_combine(tuple(e[..., 2::2] for e in m), left,
                           tuple(e[..., 2::2] for e in v))
    return _interleave(v, even, odd, n)


def _one_pole_combine(left, right):
    """right o left for one-pole maps s -> a s + v."""
    la, lv = left
    ra, rv = right
    return (ra * la, ra * lv + rv)


def _matrix_powers(A, k: int):
    """[A^0, ..., A^k] by log-doubling: P_2m = [P_m, A^m P_m].
    A (..., 2, 2) -> (..., k+1, 2, 2)."""
    Ps = torch.eye(2, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (1, 2, 2))
    Am = A
    while Ps.shape[-3] < k + 1:
        Ps = torch.cat([Ps, Am.unsqueeze(-3) @ Ps], dim=-3)
        Am = Am @ Am
    return Ps[..., :k + 1, :, :]


def _scan_operands(A, chunk: int, nc: int):
    """The operands of `affine_scan_2x2` that depend only on A, the chunk
    and the chunk count: the powers Ps (a.., chunk+1, 2, 2), the
    block-Toeplitz T (a.., 2 chunk, 2 chunk) and, for nc > 1, the chunk
    maps' matrix tree and their prefix matrices (c11, c12, c21, c22)."""
    dt, dev = A.dtype, A.device
    Ps = _matrix_powers(A, chunk)                   # (a.., chunk+1, 2, 2)
    # win[i, a] = sum_{j<i, b} (A^(i-1-j))_ab bu[j, b]: one product of the
    # chunk's (j, b)-interleaved drive with the block-Toeplitz
    # T[(j, b), (i, a)] = (A^(i-1-j))_ab (j < i, else 0).  One GEMM and
    # no stack; on the f64 18-20 Hz output-filter biquads its rounding
    # moves the output ~4e-13 under a 1-ulp input change, where four
    # (chunk x chunk) products summed moved it ~1e-12
    idx = lambda: np.subtract.outer(np.arange(chunk), np.arange(chunk)) - 1
    idxc, = device_constants(_SCAN_CONSTANTS, ("toeplitz_index", chunk),
                             lambda: (np.clip(idx(), 0, chunk),), torch.long,
                             dev)
    mask, = device_constants(_SCAN_CONSTANTS, ("toeplitz_mask", chunk),
                             lambda: (idx() >= 0,), dt, dev)
    T = Ps[..., idxc, :, :] * mask[:, :, None, None]   # (a.., i, j, a, b)
    T = T.permute(*range(T.dim() - 4), -3, -1, -4, -2).reshape(
        T.shape[:-4] + (2 * chunk, 2 * chunk))
    if nc == 1:
        return Ps, T, None, None
    # the chunk maps (A^chunk, v_c): their matrices depend on the batch
    # only through A (a.., nc), broadcast against the batch
    m_tot = Ps[..., chunk, :, :]
    me = tuple(m_tot[..., a, b].unsqueeze(-1).expand(A.shape[:-2] + (nc,))
               for a in (0, 1) for b in (0, 1))
    return Ps, T, _matrix_tree(me), associative_scan(_matrix_combine, me)


def affine_scan_2x2(A, bu, s0, chunk: int = MATMUL_CHUNK, key=None):
    """Evaluate s[n+1] = A @ s[n] + bu[n] for constant A.

    A: (2, 2) or (..., 2, 2) broadcast against the batch; bu: (..., N, 2);
    s0: (..., 2).  Returns (pre_states (..., N, 2) = s[0..N-1],
    final_state (..., 2) = s[N]).  key: hashable, naming A's value (the
    host coefficients it was made from): the operands that depend only on
    A (`_scan_operands`) are then made once a (key, chunk, length, dtype,
    device) and kept, bit for bit the ones made every call (the streaming
    step runs ~25 such scans a block)."""
    dt, dev = bu.dtype, bu.device
    batch = bu.shape[:-2]
    n = bu.shape[-2]
    A = torch.as_tensor(A, dtype=dt, device=dev)
    s0 = torch.as_tensor(s0, dtype=dt, device=dev).expand(batch + (2,))
    chunk = min(chunk, n)
    nc = -(-n // chunk)
    npad = nc * chunk
    if key is None:
        Ps, T, levels, prefix = _scan_operands(A, chunk, nc)
    else:
        full = (key, chunk, nc, dt, dev)
        got = _SCAN_OPERANDS.get(full)
        if got is None:
            got = _SCAN_OPERANDS[full] = _scan_operands(A, chunk, nc)
            if len(_SCAN_OPERANDS) > SCAN_OPERANDS_KEPT:
                _SCAN_OPERANDS.popitem(last=False)
        else:
            _SCAN_OPERANDS.move_to_end(full)
        Ps, T, levels, prefix = got
    bu_last = bu[..., n - 1, :]
    if npad != n:
        bu = torch.nn.functional.pad(bu, (0, 0, 0, npad - n))
    bu_r = bu.reshape(batch + (nc, chunk, 2))
    win = (bu_r.reshape(batch + (nc, 2 * chunk)) @ T).reshape(
        batch + (nc, chunk, 2))
    # the 2x2 products as einsums (one GEMM or one batched GEMM): a
    # broadcast `@` over the (..., nc, chunk) batch would run as a loop
    # of batched matrix-vector calls
    if nc > 1:
        # chunk totals: s_{c+1} = A^chunk s_c + (A win[c, -1] + bu[c, -1])
        v_tot = torch.einsum("...ab,...cb->...ca", A,
                             win[..., -1, :]) + bu_r[..., -1, :]
        c11, c12, c21, c22 = prefix
        cv1, cv2 = _affine_vector_scan(levels, (v_tot[..., 0],
                                                v_tot[..., 1]))
        post_c1 = c11 * s0[..., :1] + c12 * s0[..., 1:] + cv1
        post_c2 = c21 * s0[..., :1] + c22 * s0[..., 1:] + cv2
        start = torch.stack(
            [torch.cat([s0[..., :1], post_c1[..., :-1]], dim=-1),
             torch.cat([s0[..., 1:], post_c2[..., :-1]], dim=-1)], dim=-1)
    else:
        start = s0.unsqueeze(-2)                    # (..., 1, 2)
    # pre[c, i] = A^i start[c] + win[c, i]
    pre = torch.einsum("...iab,...cb->...cia", Ps[..., :chunk, :, :],
                       start) + win
    pre = pre.reshape(batch + (npad, 2))[..., :n, :]
    final = torch.einsum("...ab,...b->...a", A, pre[..., n - 1, :]) + bu_last
    return pre, final


def _complex_one_pole(v, p, chunk: int = MATMUL_CHUNK):
    """w[n] = p w[n-1] + v[n] from w[-1] = 0 for a constant complex pole
    p (JAX :370-446): the inclusive outputs of a real v (..., N) as a
    complex tensor (complex64 for f32, complex128 for f64).  Within a
    chunk win[i] = sum_{j<=i} p^(i-j) v[j], one real GEMM against the
    interleaved real and imaginary parts of the lower-triangular Toeplitz
    (|entries| = r^k <= 1: well conditioned in f32); the chunk-boundary
    states b[c] = p^chunk b[c-1] + win[c, -1] by `associative_scan`; the
    chunk-start state enters each sample through the ramp p^(i+1)."""
    p = complex(p)
    cdt = {torch.float32: torch.complex64,
           torch.float64: torch.complex128}[v.dtype]
    dev = v.device
    batch = v.shape[:-1]
    n = v.shape[-1]
    chunk = min(chunk, n)
    nc = -(-n // chunk)
    npad = nc * chunk
    if npad != n:
        v = torch.nn.functional.pad(v, (0, npad - n))
    k = np.subtract.outer(np.arange(chunk), np.arange(chunk))
    T = np.where(k >= 0, p ** np.maximum(k, 0), 0.0)     # T[i, j] = p^(i-j)
    Ti = np.stack([T.T.real, T.T.imag], axis=-1).reshape(chunk, 2 * chunk)
    win = torch.view_as_complex(
        (v.reshape(batch + (nc, chunk))
         @ torch.as_tensor(Ti, dtype=v.dtype, device=dev))
        .reshape(batch + (nc, chunk, 2)))
    if nc > 1:
        pch = torch.full((nc,), p ** chunk, dtype=cdt, device=dev)
        _, after = associative_scan(_one_pole_combine, (pch, win[..., -1]))
        start = torch.nn.functional.pad(after[..., :-1], (1, 0))
    else:
        start = torch.zeros(batch + (1,), dtype=cdt, device=dev)
    ramp = torch.as_tensor(p ** (np.arange(chunk) + 1), dtype=cdt,
                           device=dev)
    w = win + start.unsqueeze(-1) * ramp
    return w.reshape(batch + (npad,))[..., :n]


def one_pole_scan(x, a, b, s0=0.0):
    """s[n+1] = a s[n] + b x[n] along the last axis (JAX :523-565), as
    the JAX package computes it: `associative_scan` within chunks of
    DEFAULT_CHUNK, then across the chunk totals.  a, b: host scalars or
    tensors broadcast against x.shape[:-1]; s0 likewise.  Returns
    (pre-states s[0..N-1] (..., N), final state s[N] (...))."""
    dt, dev = x.dtype, x.device
    batch = x.shape[:-1]
    n = x.shape[-1]
    bu = torch.as_tensor(b, dtype=dt, device=dev).expand(batch) \
        .unsqueeze(-1) * x
    chunk = min(DEFAULT_CHUNK, n)
    nc = -(-n // chunk)
    npad = nc * chunk
    if npad != n:
        bu = torch.nn.functional.pad(bu, (0, npad - n))
    shp = batch + (nc, chunk)
    bu = bu.reshape(shp)
    # the maps' coefficients depend on the batch only through a
    a = torch.as_tensor(a, dtype=dt, device=dev)
    ae = a.reshape(a.shape + (1, 1)).expand(a.shape + (1, chunk))
    ms, vs = associative_scan(_one_pole_combine, (ae, bu))
    s0 = torch.as_tensor(s0, dtype=dt, device=dev).expand(batch)
    if nc > 1:
        cm, cv = associative_scan(_one_pole_combine, (
            ms[..., -1].expand(ms.shape[:-2] + (nc,)), vs[..., -1]))
        post_c = cm * s0.unsqueeze(-1) + cv
        start = torch.cat([s0.unsqueeze(-1), post_c[..., :-1]], dim=-1)
    else:
        start = s0.unsqueeze(-1)
    post = ms * start.unsqueeze(-1) + vs
    pre = torch.cat([start.unsqueeze(-1), post[..., :-1]], dim=-1)
    pre = pre.reshape(batch + (npad,))[..., :n]
    final = post.reshape(batch + (npad,))[..., n - 1]
    return pre, final


def _tdf2_final_state(x, y, b1, b2, a1, a2):
    """The TDF2 state after the last sample, rebuilt from the last two
    inputs and outputs (zero before the first):
    z1 = b1 x[-1] - a1 y[-1] + (b2 x[-2] - a2 y[-2]),
    z2 = b2 x[-1] - a2 y[-1]."""
    xm1, ym1 = x[..., -1], y[..., -1]
    if x.shape[-1] >= 2:
        xm2, ym2 = x[..., -2], y[..., -2]
    else:
        xm2, ym2 = torch.zeros_like(xm1), torch.zeros_like(ym1)
    z1 = b1 * xm1 - a1 * ym1 + (b2 * xm2 - a2 * ym2)
    z2 = b2 * xm1 - a2 * ym1
    return torch.stack([z1, z2], dim=-1)


def _biquad_fir_f32(x, b0, b1, b2, a1, a2):
    """A low-radius biquad as its impulse response truncated to
    BIQUAD_FIR_TAPS taps (computed on the host in f64), run through
    `_fir_matmul` (JAX :68-97); the final TDF2 state from the tail."""
    from .oversample import _fir_matmul
    h = np.zeros(BIQUAD_FIR_TAPS)
    z1 = z2 = 0.0
    xi = 1.0
    for k in range(BIQUAD_FIR_TAPS):
        y = b0 * xi + z1
        z1 = b1 * xi - a1 * y + z2
        z2 = b2 * xi - a2 * y
        h[k] = y
        xi = 0.0
    y = _fir_matmul(x, h)
    return y, _tdf2_final_state(x, y, b1, b2, a1, a2)


def _biquad_scan_diag(x, b0, b1, b2, a1, a2, s0=None):
    """A scalar-coefficient biquad from zero state by pole diagonalization
    (JAX :449-497): v = b0 x + b1 x[n-1] + b2 x[n-2]; a complex pole pair
    gives y = 2 Re(r w), w the one-pole of v at p, r = p / (p - conj p);
    real poles (repeated included) two cascaded real one-poles.  An
    initial state goes to the 2x2 form.  Returns (y, final TDF2 state)."""
    if s0 is not None:
        return _biquad_scan_2x2(x, b0, b1, b2, a1, a2, s0)
    x1 = torch.nn.functional.pad(x, (1, 0))[..., :-1]
    x2 = torch.nn.functional.pad(x, (2, 0))[..., :-2]
    v = b0 * x + b1 * x1 + b2 * x2
    disc = a1 * a1 - 4.0 * a2
    if a1 == 0.0 and a2 == 0.0:
        y = v
    elif disc < 0.0:
        p = complex(-a1 / 2.0, np.sqrt(-disc) / 2.0)
        r = p / (p - np.conj(p))
        y = 2.0 * (_complex_one_pole(v, p) * r).real
    else:
        sq = np.sqrt(max(disc, 0.0))
        p = (-a1 + sq) / 2.0
        q = (-a1 - sq) / 2.0
        pre_p, _ = one_pole_scan(v, p, 1.0)
        u = p * pre_p + v            # the inclusive one-pole output
        pre_q, _ = one_pole_scan(u, q, 1.0)
        y = q * pre_q + u
    return y, _tdf2_final_state(x, y, b1, b2, a1, a2)


def _all_scalar(coeffs) -> bool:
    """Host scalars (one shared transition), not per-stream arrays."""
    return all(np.ndim(c) == 0 and not torch.is_tensor(c) for c in coeffs)


def _biquad_scan_2x2(x, b0, b1, b2, a1, a2, s0):
    """The companion-matrix form (JAX :500-520): coefficients host
    scalars (one shared transition) or tensors broadcast against
    x.shape[:-1]; s0 (..., 2) or None (zero)."""
    dt, dev = x.dtype, x.device
    batch = x.shape[:-1]
    if _all_scalar((b0, b1, b2, a1, a2)):
        A, = device_constants(
            _SCAN_CONSTANTS, ("companion", float(a1), float(a2)),
            lambda: (np.array([[-a1, 1.0], [-a2, 0.0]]),), dt, dev)
        c1, c2 = b1 - a1 * b0, b2 - a2 * b0
        key = ("companion", float(a1), float(a2))
    else:
        b0, b1, b2, a1, a2 = (torch.as_tensor(c, dtype=dt, device=dev)
                              .expand(batch) for c in (b0, b1, b2, a1, a2))
        A = torch.stack([torch.stack([-a1, torch.ones_like(a1)], dim=-1),
                         torch.stack([-a2, torch.zeros_like(a2)], dim=-1)],
                        dim=-2)
        c1 = (b1 - a1 * b0).unsqueeze(-1)
        c2 = (b2 - a2 * b0).unsqueeze(-1)
        b0 = b0.unsqueeze(-1)
        key = None
    bu = torch.stack([x * c1, x * c2], dim=-1)
    if s0 is None:
        s0 = torch.zeros(batch + (2,), dtype=dt, device=dev)
    pre, final = affine_scan_2x2(A, bu, torch.as_tensor(s0, dtype=dt,
                                                        device=dev), key=key)
    return b0 * x + pre[..., 0], final


def biquad_route(dtype, b0, b1, b2, a1, a2, s0=None) -> str:
    """The route "auto" takes (JAX :302-328, without the accelerator's f64
    branch): f32 scalar-coefficient biquads to "diag" above
    POLE_RADIUS_DIAG_F32, to "fir" at or below POLE_RADIUS_FIR_F32 from
    zero state; everything else to "2x2"."""
    if _all_scalar((b0, b1, b2, a1, a2)) and dtype != torch.float64:
        rmax = _biquad_pole_radius(float(a1), float(a2))
        if rmax > POLE_RADIUS_DIAG_F32:
            return "diag"
        if s0 is None and rmax <= POLE_RADIUS_FIR_F32:
            return "fir"
    return "2x2"


def biquad_df2t_scan(x, b0, b1, b2, a1, a2, s0=None, method: str = "auto"):
    """Transposed-direct-form-II biquad along the last axis of x
    (JAX :286-367):

        y[n]    = b0 x[n] + z1[n]
        z1[n+1] = b1 x[n] - a1 y[n] + z2[n]
        z2[n+1] = b2 x[n] - a2 y[n]

    method: "auto" (`biquad_route`), "fir", "diag" or "2x2"; "fir" and
    "diag" take scalar coefficients ("fir" also zero state) and otherwise
    fall to "2x2", as in the JAX package.  Returns (y, final state
    (..., 2))."""
    if method == "auto":
        method = biquad_route(x.dtype, b0, b1, b2, a1, a2, s0)
    scalar = _all_scalar((b0, b1, b2, a1, a2))
    if method == "fir" and scalar and s0 is None:
        return _biquad_fir_f32(x, float(b0), float(b1), float(b2),
                               float(a1), float(a2))
    if method == "diag" and scalar:
        return _biquad_scan_diag(x, float(b0), float(b1), float(b2),
                                 float(a1), float(a2), s0)
    return _biquad_scan_2x2(x, b0, b1, b2, a1, a2, s0)

"""Linear recurrences (counterpart of convopeq_tpu/ops/scan_iir.py).

Ported here: `_biquad_pole_radius` (host) and `affine_scan_2x2` in its
matmul form (convopeq_tpu/ops/scan_iir.py:107-222): within a chunk the
solution of s[n+1] = A s[n] + bu[n] is a strictly lower-triangular
block-Toeplitz product, and the chunk-boundary states follow the same
kind of recurrence over N/chunk elements, s_c+1 = A^chunk s_c + v_c.
The JAX package solves that one with an associative scan; torch has none,
so here it recurses into `affine_scan_2x2` itself, on both devices, until
the boundary sequence fits one chunk (depth log_chunk N: 2 at config6's
3,750 DC-blocker chunks).  No Python loop runs over the boundaries.

Time is the second-to-last axis of `bu` (..., N, 2); leading axes are
batch.  Matmuls run in the tensors' type (no TF32: `device.resolve_device`
turns it off on the card).
"""
from __future__ import annotations

import numpy as np
import torch

MATMUL_CHUNK = 128


def _biquad_pole_radius(a1: float, a2: float) -> float:
    """Largest pole magnitude of z^2 + a1 z + a2."""
    disc = a1 * a1 - 4.0 * a2
    if disc < 0.0:
        return float(np.sqrt(max(a2, 0.0)))
    s = np.sqrt(disc)
    return float(max(abs((-a1 + s) / 2.0), abs((-a1 - s) / 2.0)))


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


def affine_scan_2x2(A, bu, s0, chunk: int = MATMUL_CHUNK):
    """Evaluate s[n+1] = A @ s[n] + bu[n] for constant A.

    A: (2, 2) or (..., 2, 2) broadcast against the batch; bu: (..., N, 2);
    s0: (..., 2).  Returns (pre_states (..., N, 2) = s[0..N-1],
    final_state (..., 2) = s[N])."""
    dt, dev = bu.dtype, bu.device
    batch = bu.shape[:-2]
    n = bu.shape[-2]
    A = torch.as_tensor(A, dtype=dt, device=dev)
    s0 = torch.as_tensor(s0, dtype=dt, device=dev).expand(batch + (2,))
    chunk = min(chunk, n)
    nc = -(-n // chunk)
    npad = nc * chunk
    bu_last = bu[..., n - 1, :]
    if npad != n:
        bu = torch.nn.functional.pad(bu, (0, 0, 0, npad - n))
    bu_r = bu.reshape(batch + (nc, chunk, 2))
    # A is either shared (2, 2) or per batch element (batch, 2, 2), and
    # the powers and Toeplitz factors carry A's leading shape
    Ps = _matrix_powers(A, chunk)                   # (a.., chunk+1, 2, 2)
    # T_ab[i, j] = (A^(i-1-j))_ab for j < i, else 0 (strictly lower)
    idx = np.subtract.outer(np.arange(chunk), np.arange(chunk)) - 1
    idxc = torch.as_tensor(np.clip(idx, 0, chunk), device=dev)
    mask = torch.as_tensor(idx >= 0, dtype=dt, device=dev)

    def toeplitz(a, b):
        return Ps[..., a, b][..., idxc] * mask      # (a.., chunk, chunk)

    def mm(T, v):                                   # (.., nc, chunk) @ T^T
        return v @ T.transpose(-1, -2)

    bu1, bu2 = bu_r[..., 0], bu_r[..., 1]
    win = torch.stack([mm(toeplitz(0, 0), bu1) + mm(toeplitz(0, 1), bu2),
                       mm(toeplitz(1, 0), bu1) + mm(toeplitz(1, 1), bu2)],
                      dim=-1)                       # (..., nc, chunk, 2)
    shared = A.dim() == 2
    Ab = A if shared else A.unsqueeze(-3)
    if nc > 1:
        # chunk totals: s_{c+1} = A^chunk s_c + (A win[c, -1] + bu[c, -1])
        v_tot = (win[..., -1, :].unsqueeze(-2) @ Ab.transpose(-1, -2)
                 ).squeeze(-2) + bu_r[..., -1, :]
        start, _ = affine_scan_2x2(Ps[..., chunk, :, :], v_tot, s0, chunk)
    else:
        start = s0.unsqueeze(-2)                    # (..., 1, 2)
    # pre[c, i] = A^i start[c] + win[c, i]
    Pi = Ps[..., :chunk, :, :]
    if not shared:
        Pi = Pi.unsqueeze(-4)
    pre = (Pi @ start.unsqueeze(-2).unsqueeze(-1)).squeeze(-1) + win
    pre = pre.reshape(batch + (npad, 2))[..., :n, :]
    final = (A @ pre[..., n - 1, :].unsqueeze(-1)).squeeze(-1) + bu_last
    return pre, final

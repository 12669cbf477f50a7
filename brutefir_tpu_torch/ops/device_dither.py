"""Device-resident HP-TPDF dither with error feedback.

Torch twin of :mod:`brutefir_tpu.ops.device_dither`, bit-equal with it.
Plain torch ops: the JAX package computes this in ``jnp`` inside its
device program, not in a Pallas kernel.

The reference's dithered quantizer (`dither_funs.h:7-68`) is a sequential
per-sample recurrence:

    real[i] = x[i] + e[i-1] - e[i-2]        # {1,-1} error feedback
    s[i]    = floor(real[i] + d[i])         # dither d folds the mid-tread
    e[i]    = real[i] - s[i]                #   +0.5 offset (dither.c randmap)

The parallel form removes the sequential dependence exactly. With
t[i] = real[i] + d[i] and g[i] = t[i] mod 1, substitute e[i] = g[i] - d[i]
into the recurrence:

    t[i] = v[i] + g[i-1] - g[i-2],   v[i] = x[i] + d[i] - d[i-1] + d[i-2]
    g[i] = (v[i] + g[i-1] - g[i-2]) mod 1

Because adding integers never changes a value mod 1, ``g`` equals the
mod-1 reduction of the *linear* recurrence G[i] = v[i] + G[i-1] - G[i-2],
whose kernel h (h[k] = h[k-1] - h[k-2]) is periodic with period 6:
1, 1, 0, -1, -1, 0.  So

    G[i] = sum_j c[(i - j) mod 6] * v[j],   c = [1, 1, 0, -1, -1, 0]

which is six masked cumulative sums -- fully parallel. The mod-1
arithmetic runs in int32 fixed point modulo 2^32 (1 ulp = 2^-32), so the
prefix sums are exact mod 1 regardless of block length; only the initial
float->fixed conversion rounds (<= 2^-25 per element, accumulating to
< 1e-4 over an 8192 block -- far below the f32 recurrence's own rounding,
which at 2^20 amplitudes works on a 1/16-LSB grid).

The quantization itself splits x into integer + fractional parts so the
floor() decision keeps full precision at any amplitude (the reference's
f32 ``real`` loses dither resolution above ~2^20).

Parity deviations from the reference (docs/PARITY.md), the JAX package's:
outputs match the reference's f32 recurrence bit for bit at small
amplitudes and within +-1..2 LSB at large ones (the *reference's* f32
rounding); on a clipped sample this path keeps the unclipped feedback.

The dither sequence itself is bit-exact: the same Tausworthe table and
randmap (core/dither.py) live on the device, with the reference's pointer
wrap semantics (dither.h:28-38) carried as explicit state.

The float ops follow ``x.dtype`` as the JAX module's do: under
``float_bits: 64`` the same fixed-point mod-1 path runs in float64, with
the float32-derived clip thresholds cast up.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# period-6 kernel of G[i] = v[i] + G[i-1] - G[i-2]
_KERNEL = (1, 1, 0, -1, -1, 0)
_U32 = 0xFFFFFFFF


def dither_window(tab: torch.Tensor, randmap: torch.Tensor,
                  ptr: torch.Tensor, last: torch.Tensor, n: int, size: int):
    """Per-channel dither floats for one block + advanced pointer state.

    tab: [size] int8 (device copy of the shared Tausworthe table)
    randmap: [512] f32   ptr: [C] int32   last: [C] int32 (previous byte --
    replaces the reference's ``tab[0] = tab[ptr-1]`` in-place wrap write)
    Returns (d [C, n] f32, new_ptr [C] int32, new_last [C] int32).
    """
    # wrap BEFORE the window when it would run off the table
    # (dither.h:28-33); the table is sized so a block always fits
    wraps = ptr + n >= size
    p = torch.where(wraps, torch.ones_like(ptr), ptr).long()      # [C]
    idx = p[:, None] + torch.arange(n, device=p.device)[None, :]
    cur = tab[idx].to(torch.int32)                                # [C, n]
    # prev is cur shifted by one sample; only column 0 needs its own gather,
    # and on a wrap it continues from the last consumed byte
    prev0 = torch.where(wraps, last, tab[p - 1].to(torch.int32))
    prev = torch.cat([prev0[:, None], cur[:, :-1]], dim=1)
    d = randmap[(cur - prev + 256).long()]                        # [C, n]
    return d, (p + n).to(torch.int32), cur[:, -1]


@functools.lru_cache(maxsize=16)
def _phase_tables(n: int, device):
    """[6, n] bool masks (i % 6 == r) and [6, n] int64 coefficients
    c[(i - r) % 6], cached per length and device (building them per block
    would be host -> device copies)."""
    i = np.arange(n)
    masks = np.stack([i % 6 == r for r in range(6)])
    coefs = np.stack([np.asarray(_KERNEL)[(i - r) % 6] for r in range(6)])
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(coefs.astype(np.int64), device=device))


def _clip_thresholds(imin: int, imax: int):
    """(over_t, clamp_hi): the exact f32 threshold above which a dithered
    value counts as over (f32(imax) rounds UP to 2^31 for 32-bit formats,
    so ``t >= over_t`` stands for ``t > imax``), and the largest f32 below
    it, the clamp that keeps the int32 cast in range."""
    c = np.float32(imax)
    over_t = (c if np.float64(c) > imax
              else np.nextafter(c, np.float32(np.inf)))
    clamp_hi = np.nextafter(np.float32(over_t), np.float32(-np.inf))
    return float(over_t), float(clamp_hi)


def dither_quantize(x: torch.Tensor, d: torch.Tensor, sf: torch.Tensor,
                    imin: int, imax: int):
    """Parallel HP-TPDF dithered quantization of one block.

    x: [C, N] f32 (scaled to integer units)   d: [C, N] f32 dither
    sf: [C, 2] f32 error-feedback state (sf[:,0]=e[-1], sf[:,1]=e[-2])
    (float64 all three under ``float_bits: 64``: every float op below is
    in x's dtype, as the JAX version's ``f32 = x.dtype.type``).
    Returns (s [C, N] int32, new_sf [C, 2], meters [C, 3] of x's dtype:
    [overflow count, clipped |peak|, unclipped int peak]).
    """
    C, N = x.shape
    rd = x.dtype
    real = np.float64 if rd == torch.float64 else np.float32
    xi = torch.floor(x)                                # exact in f32
    xf = x - xi                                        # [0, 1), exact
    # v[i] = x[i] + d[i] - d[i-1] + d[i-2] (+ feedback seed at i < 2);
    # only the small parts enter the mod-1 path. Each add rounds once, in
    # the JAX package's order.
    vf = xf + d
    vf[:, 1:] += -d[:, :-1]
    vf[:, 2:] += d[:, :-2]
    vf[:, 0] += sf[:, 0] - sf[:, 1]
    if N > 1:
        vf[:, 1] += -sf[:, 0]
    # fixed point mod 1: 1 ulp = 2^-32. torch.remainder is the floor mod
    # of jnp.mod (fmod, then + 1 where the result is negative), so a tiny
    # negative vf gives 1.0 and the value 2^24 << 8 = 2^32, which is 0
    # modulo 2^32 as in the JAX package's int32 shift. The int32 wrapping
    # sums are done here in int64 (exact: |sums| < N * 2^33) and reduced
    # modulo 2^32 once, with ``& 0xFFFFFFFF``, which equals the JAX
    # package's bitcast of its wrapped int32 to uint32.
    V = torch.round(torch.remainder(vf, 1.0) * 2.0 ** 24).to(torch.int64) << 8
    masks, coefs = _phase_tables(N, x.device)
    G = torch.zeros((C, N), dtype=torch.int64, device=x.device)
    zero = torch.zeros((), dtype=torch.int64, device=x.device)
    for r in range(6):
        P = torch.cumsum(torch.where(masks[r][None, :], V, zero), dim=1)
        G += coefs[r][None, :] * P
    g = (G & _U32).to(rd) * 2.0 ** -32                # frac(G) in [0, 1)
    # t[i] = v[i] + g[i-1] - g[i-2]; the small part carries the floor
    tf = vf.clone()
    tf[:, 1:] += g[:, :-1]
    if N > 1:
        tf[:, 2:] += -g[:, :-2]
    t_val = xi + tf                                    # the dithered value
    s = xi + torch.floor(tf)                           # full-precision floor
    # the host's clip and count rule (dither_funs.h / _quantize_py): count
    # on the PRE-floor dithered value, ``dithered <= rmin`` or over the
    # exact f32 threshold (t in (imax, imax+1) floors to imax but still
    # counts); clipped samples take imax as the host's clip_hi rule does
    over_t, clamp_hi = _clip_thresholds(imin, imax)
    over = t_val >= over_t
    ovf = (t_val <= float(real(imin))) | over
    sq = torch.where(over, torch.full_like(s, imax, dtype=torch.int32),
                     torch.clamp(s, float(real(imin)),
                                 clamp_hi).to(torch.int32))
    # meters in encode_words' convention: [n_overflows, clip peak, int peak]
    mag = torch.abs(t_val)
    meters = torch.stack([
        torch.sum(ovf.to(rd), dim=1),
        torch.amax(torch.where(ovf, mag, torch.zeros_like(mag)), dim=1),
        torch.amax(torch.where(ovf, torch.zeros_like(sq), torch.abs(sq)),
                   dim=1).to(rd),
    ], dim=1)
    # e[i] = g[i] - d[i]; the block boundary carries the last two
    sf0 = g[:, -1] - d[:, -1]
    sf1 = (g[:, -2] - d[:, -2]) if N > 1 else sf[:, 0]
    return sq, torch.stack([sf0, sf1], dim=1), meters

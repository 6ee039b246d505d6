"""LUT-Q: dictionary + assignment quantization with iterative k-means.

PyTorch counterpart of ``repro.core.lutq`` (the paper's Table 1):

  step 1   Q = d[A]                      -> :func:`decode`
  step 2/3 STE forward + master update   -> :func:`quantize_ste`
  step 4   M k-means iterations on (A,d) -> :func:`update_state`

Assignment is 1-D nearest-neighbour search against a *sorted*
dictionary, done by bucketizing against the K-1 midpoints
(``torch.searchsorted`` with ``right=False``, the reference's
``side="left"``: a weight exactly on a midpoint goes to the lower
entry).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.spec import QuantSpec


class LutqState(NamedTuple):
    """Quantization state for one weight tensor.

    w: full-precision master weights, or None in the serve form.
    d: dictionary (K,), sorted ascending, float32.
    a: assignments shaped like w: int8 indices, or uint8 when two 4-bit
      indices are packed per byte along the reduction axis (serve form).
      K=256 dictionaries store indices >= 128 as int8 two's complement.
    sid: int32 id of the QuantPolicy rule that produced the state.
    act: frozen activation-quant pair ``[scale, qmax]``, or None.

    One layer's dictionary is its own (K,) tensor: the port keeps the
    layer stack as per-layer modules instead of (L, ...) stacks.
    """

    w: Optional[torch.Tensor]
    d: torch.Tensor
    a: torch.Tensor
    sid: Optional[torch.Tensor] = None
    act: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# step 1: decode tied weights
# ---------------------------------------------------------------------------

def index_of(a: torch.Tensor) -> torch.Tensor:
    """int64 gather indices of an assignment tensor.

    int8 assignments are read as their unsigned byte, so a K=256
    dictionary's entry 128 (stored as int8 -128) is entry 128, exactly as
    the reference's ``jnp.take`` wraps negative indices.
    """
    if a.dtype == torch.int8:
        a = a.view(torch.uint8)
    return a.long()


def decode(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Q = d[A] (paper step 1)."""
    return d[index_of(a)]


# ---------------------------------------------------------------------------
# steps 2/3: straight-through estimator
# ---------------------------------------------------------------------------

class _SteExact(torch.autograd.Function):
    """Forward: exactly ``d[A]`` in w's dtype. Backward: dC/dW = dC/dQ
    (paper step 3); d and A get no gradient."""

    @staticmethod
    def forward(ctx, w, d, a):
        return decode_any(d, a).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def quantize_ste(w: torch.Tensor, d: torch.Tensor, a: torch.Tensor
                 ) -> torch.Tensor:
    """Forward value is *exactly* Q = d[A]; the gradient flows straight
    to w.

    Bit-exactness of the forward value matters for the multiplier-less
    claims (decoded weights must be exact dictionary entries), hence an
    autograd Function instead of the ``w + (q - w).detach()`` trick,
    which rounds ``w + (q - w)`` back to something other than q.
    """
    return _SteExact.apply(w, d, a)


def quantize_ste_any(w: torch.Tensor, d: torch.Tensor, a: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`quantize_ste` of any leaf (the port's leaves are per layer,
    so there are no stacked dictionaries to map over)."""
    return quantize_ste(w, d, a)


def decode_any(d: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """decode() of a serve-form leaf: an int8 ``d`` is a pow2
    sign+exponent plane, which is not ported yet. (The reference also
    takes stacked (L, K) dictionaries here; the port's leaves are
    per layer.)"""
    if d.dtype == torch.int8:
        raise NotImplementedError(
            "pow2 sign+exponent dictionaries are not ported yet "
            "(ROADMAP queue 1 item 4)")
    return decode(d, a)


# ---------------------------------------------------------------------------
# dictionary constraints
# ---------------------------------------------------------------------------

POW2_MIN_EXP = -14
POW2_MAX_EXP = 15


def pow2_round(x: torch.Tensor, min_exp: int = POW2_MIN_EXP,
               max_exp: int = POW2_MAX_EXP) -> torch.Tensor:
    """Round magnitudes to the nearest power of two, keep sign.

    Entries exactly 0 stay 0 (the pruning slot). Exponents are clamped
    so decoded bf16/f16 values stay representable.
    """
    mag = x.abs()
    safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    e = torch.clamp(torch.round(torch.log2(safe)), min_exp, max_exp)
    p = torch.exp2(e)
    return torch.where(mag > 0, torch.sign(x) * p,
                       torch.zeros_like(x)).to(x.dtype)


def _fixed_dictionary(spec: QuantSpec, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    if spec.constraint == "binary":
        return torch.tensor([-1.0, 1.0], dtype=dtype, device=device)
    if spec.constraint == "ternary":
        return torch.tensor([-1.0, 0.0, 1.0], dtype=dtype, device=device)
    raise ValueError(spec.constraint)


def apply_constraint(d: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Project a (sorted) dictionary onto the spec's constraint set."""
    if spec.constraint == "pow2":
        d = pow2_round(d)
    elif spec.fixed_dictionary:
        d = _fixed_dictionary(spec, d.dtype, d.device)
    if spec.prune_frac > 0.0:
        # pin the entry nearest zero to exactly zero
        d = d.clone()
        d[torch.argmin(d.abs())] = 0.0
    return torch.sort(d).values


# ---------------------------------------------------------------------------
# assignment: 1-D nearest neighbour over a sorted dictionary
# ---------------------------------------------------------------------------

def _bucketize(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int64 index of the nearest entry; ties go to the lower entry."""
    mid = ((d[:-1] + d[1:]) * 0.5).contiguous()
    return torch.searchsorted(mid, w.to(d.dtype).contiguous(), right=False)


def assign(w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A_ij = argmin_k |W_ij - d_k| for sorted d. Returns int8."""
    return _bucketize(w, d).to(torch.int8)


def _fixed_scale_update(d, w, a, spec: QuantSpec) -> torch.Tensor:
    """TWN/BWN-style per-tensor scale for fixed dictionaries."""
    if not spec.fixed_scale:
        return d
    sign = torch.sign(d)
    aw = w.float().abs()
    if spec.constraint == "ternary":
        delta = 0.7 * aw.mean()
        sel = aw > delta
        num = torch.where(sel, aw, torch.zeros_like(aw)).sum()
        den = torch.clamp(sel.float().sum(), min=1.0)
        alpha = torch.clamp(num / den, min=1e-12)
    else:
        alpha = torch.clamp(aw.mean(), min=1e-12)
    return sign * alpha


def _prune_mask(w: torch.Tensor, prune_frac: float) -> torch.Tensor:
    """Boolean mask of weights forced to the zero entry (smallest |w|)."""
    flat = w.reshape(-1).abs()
    k = int(round(prune_frac * flat.numel()))
    if k <= 0:
        return torch.zeros(w.shape, dtype=torch.bool, device=w.device)
    thresh = torch.kthvalue(flat, k).values
    return w.abs() <= thresh


def _recenter(d, sums, counts, spec: QuantSpec) -> torch.Tensor:
    """Empty clusters keep their previous centroid."""
    new_d = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), d)
    return apply_constraint(new_d.to(d.dtype), spec)


# ---------------------------------------------------------------------------
# step 4: M k-means iterations
# ---------------------------------------------------------------------------

def kmeans_update(w: torch.Tensor, d: torch.Tensor, spec: QuantSpec
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M k-means iterations on the (sorted) dictionary, then reassign.

    Returns (new_d, new_a). One-hot form, for leaves below
    ``_SEGSUM_THRESHOLD`` elements.
    """
    K = spec.K
    flat = w.reshape(-1).float()
    pmask = (_prune_mask(w, spec.prune_frac).reshape(-1)
             if spec.prune_frac > 0.0 else None)
    for _ in range(spec.kmeans_iters):
        a = _bucketize(flat, d)
        if pmask is not None:
            a = torch.where(pmask, torch.argmin(d.abs()), a)
        if spec.fixed_dictionary:
            d = _fixed_scale_update(d, flat, a, spec)
            continue
        onehot = torch.nn.functional.one_hot(a, K).float()  # (N, K)
        d = _recenter(d, onehot.T @ flat, onehot.sum(0), spec)
    a = assign(w, d)
    if pmask is not None:
        zi = torch.argmin(d.abs()).to(torch.int8)
        a = torch.where(pmask.reshape(w.shape), zi, a)
    return d, a


def kmeans_update_segsum(w: torch.Tensor, d: torch.Tensor, spec: QuantSpec
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kmeans_update` as K masked reductions, for big leaves.

    No one-hot (N, K) matrix: per-entry sums and counts are K masked
    full reductions over w in its own shape, in a fixed order, so the
    result does not vary from run to run on the card.
    """
    K = spec.K
    w32 = w.float()
    pmask = _prune_mask(w, spec.prune_frac) if spec.prune_frac > 0 else None

    def assign_ids(d):
        a = _bucketize(w32, d)
        if pmask is not None:
            a = torch.where(pmask, torch.argmin(d.abs()), a)
        return a

    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    for _ in range(spec.kmeans_iters):
        a = assign_ids(d)
        if spec.fixed_dictionary:
            d = _fixed_scale_update(d, w32, a, spec)
            continue
        sums = torch.stack([torch.where(a == k, w32, zero).sum()
                            for k in range(K)])
        counts = torch.stack([(a == k).float().sum() for k in range(K)])
        d = _recenter(d, sums, counts, spec)
    return d, assign_ids(d).to(torch.int8)


def kmeans_update_stats(w: torch.Tensor, d: torch.Tensor, spec: QuantSpec
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`kmeans_update` through the ``kmeans_stats`` kernel.

    One fused pass per iteration computes assignments and per-entry sums
    and counts (one read of w, one int8 write of a), and one more pass
    gives the final assignments: ``kmeans_iters + 1`` launches per leaf.
    What the kernel cannot express is composed around its stats, as in
    the reference: fixed dictionaries take its assignment and recenter
    with :func:`_fixed_scale_update`; prune masks move each pruned
    weight's contribution from its kernel-assigned entry to the zero
    entry with K masked corrections; the constraints run on the (K,)
    dictionary.
    """
    from repro_torch.kernels import ops  # local: kernels.ops imports us

    K = spec.K
    flat = w.reshape(-1).float()
    pmask = (_prune_mask(w, spec.prune_frac).reshape(-1)
             if spec.prune_frac > 0.0 else None)

    def stats(d):
        a, sums, counts = ops.kmeans_stats(flat, d)
        if pmask is None:
            return a, sums, counts
        zi = torch.argmin(d.abs())
        ai = index_of(a)
        zero = torch.zeros((), dtype=torch.float32, device=w.device)
        m = [pmask & (ai == k) for k in range(K)]
        csum = torch.stack([torch.where(mk, flat, zero).sum() for mk in m])
        ccnt = torch.stack([mk.float().sum() for mk in m])
        sums = (sums - csum).index_add(0, zi[None], csum.sum()[None])
        counts = (counts - ccnt).index_add(0, zi[None], ccnt.sum()[None])
        return torch.where(pmask, zi.to(torch.int8), a), sums, counts

    for _ in range(spec.kmeans_iters):
        a, sums, counts = stats(d)
        if spec.fixed_dictionary:
            d = _fixed_scale_update(d, flat, a, spec)
        else:
            d = _recenter(d, sums, counts, spec)
    a, _, _ = stats(d)
    return d, a.reshape(w.shape)


_SEGSUM_THRESHOLD = 1 << 16

_KMEANS_IMPLS = {
    "dense": kmeans_update,
    "segsum": kmeans_update_segsum,
    "stats": kmeans_update_stats,
}


def resolve_kmeans_impl(n: int, impl: Optional[str] = None,
                        device=None) -> str:
    """Structural step-4 implementation for an n-element leaf on
    ``device``.

    ``None`` resolves as the reference does: dense one-hot below
    ``_SEGSUM_THRESHOLD``; above it the fused ``kmeans_stats`` kernel
    on a CUDA device (the reference's "on TPU"), and the masked-
    reduction ``segsum`` form elsewhere. Explicit names force a path
    (tests, benches); ``"stats"`` on a CPU tensor runs the kernel's
    plain version.
    """
    if impl is not None:
        if impl not in _KMEANS_IMPLS:
            raise ValueError(
                f"unknown kmeans impl {impl!r}; expected one of "
                f"{tuple(_KMEANS_IMPLS)}")
        return impl
    if n < _SEGSUM_THRESHOLD:
        return "dense"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return "stats" if on_cuda else "segsum"


def update_state(state: LutqState, spec: QuantSpec,
                 impl: Optional[str] = None) -> LutqState:
    """Paper step 4 applied to a LutqState (after the optimizer touched
    w). ``impl``: force "dense" | "segsum" | "stats"; default structural
    (:func:`resolve_kmeans_impl`). Returns new (d, a); nothing is
    written in place here."""
    w = state.w.detach()
    fn = _KMEANS_IMPLS[resolve_kmeans_impl(w.numel(), impl, w.device)]
    d, a = fn(w, state.d, spec)
    return LutqState(w=state.w, d=d, a=a, sid=state.sid, act=state.act)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def quantile_linear(flat: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(flat, qs)`` (method "linear") as sort + interpolation.

    ``torch.quantile`` refuses inputs above 2**24 elements, and the
    embedding table and MLP kernels of a full-width model are larger.
    The arithmetic follows the reference step by step in float32:
    position ``q * (n - 1)``, floor/ceil neighbours, weights ``q - low``
    and ``1 - (q - low)``.
    """
    a = torch.sort(flat).values
    n = torch.tensor(float(flat.numel()), dtype=torch.float32,
                     device=flat.device)
    pos = qs * (n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = torch.clamp(low, min=0).minimum(n - 1).long()
    high = torch.clamp(high, min=0).minimum(n - 1).long()
    return a[low] * lw + a[high] * hw


def init_dictionary(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Sorted initial dictionary from the weight distribution.

    Free/pow2 dictionaries start at the (k+0.5)/K quantiles of w; fixed
    dictionaries are the constraint set itself.
    """
    if spec.fixed_dictionary:
        base = _fixed_dictionary(spec, device=w.device)
        if spec.fixed_scale:
            alpha0 = 1.4 * w.float().abs().mean() + 1e-12
            return base * alpha0
        return base
    flat = w.reshape(-1).float()
    ar = torch.arange(spec.K, dtype=torch.float32, device=w.device)
    d = quantile_linear(flat, (ar + 0.5) / spec.K)
    # spread exact duplicates by a hair so intervals stay well-defined
    eps = 1e-8 * (1.0 + d.abs())
    d = d + eps * ar
    return apply_constraint(d.float(), spec)


def init_state(w: torch.Tensor, spec: QuantSpec) -> LutqState:
    d = init_dictionary(w, spec)
    fn = (kmeans_update_segsum if w.numel() >= _SEGSUM_THRESHOLD
          else kmeans_update)
    d, a = fn(w, d, spec)
    return LutqState(w=w, d=d, a=a)

"""ResNets: the paper's reference networks.

Counterpart of ``repro.models.resnet``. Two roles:
  * analytic layer inventories for ResNet-18/34/50 (ImageNet), which
    drive the Table 2 memory / multiplication reproduction;
  * a trainable ResNet-20-style CIFAR CNN (LUT-Q aware convs, standard
    or multiplier-less BN, optional 8-bit activations).

The parameters are a module tree whose attribute names are the
reference's keys (``stem.kernel``, ``stem_bn.p.gamma``,
``s1b0.down.kernel``, ``fc.kernel``), so ``core/policy``'s walks and the
rules resolve the same paths; ``gamma`` / ``beta`` keep BN out of
quantization. The BN running statistics are a separate ``{name:
BNStats}`` dict, passed in and returned as in the reference, so no
optimizer or policy walk touches them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.actquant import relu_fake_quant
from repro_torch.core.mlbn import (BNAffine, BNStats,
                                   apply_scale_offset_shift, batch_norm,
                                   inference_scale_offset, init_bn)
from repro_torch.device import resolve_device
from repro_torch.nn.conv import conv_apply, conv_init, normal
from repro_torch.nn.linear import Linear, dot_kernel
from repro_torch.nn.tree import leaf

# ---------------------------------------------------------------------------
# analytic ImageNet ResNet inventories
# ---------------------------------------------------------------------------

_DEPTHS = {18: ([2, 2, 2, 2], "basic"), 34: ([3, 4, 6, 3], "basic"),
           50: ([3, 4, 6, 3], "bottleneck")}


def _basic_block(cin, cout, stride):
    layers = [("conv1", 3 * 3 * cin * cout), ("conv2", 3 * 3 * cout * cout)]
    if stride != 1 or cin != cout:
        layers.append(("down", 1 * 1 * cin * cout))
    return layers


def _bottleneck(cin, cmid, stride):
    cout = cmid * 4
    layers = [("conv1", 1 * 1 * cin * cmid), ("conv2", 3 * 3 * cmid * cmid),
              ("conv3", 1 * 1 * cmid * cout)]
    if stride != 1 or cin != cout:
        layers.append(("down", 1 * 1 * cin * cout))
    return layers


def resnet_layer_sizes(depth: int) -> List[Tuple[str, int]]:
    """(name, n_params) for every conv/fc weight tensor (ImageNet)."""
    blocks, kind = _DEPTHS[depth]
    mk, expansion = ((_basic_block, 1) if kind == "basic"
                     else (_bottleneck, 4))
    sizes = [("stem", 7 * 7 * 3 * 64)]
    cin = 64
    for stage, (n, cbase) in enumerate(zip(blocks, [64, 128, 256, 512])):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            sizes += [(f"s{stage}b{b}_{n0}", p)
                      for n0, p in mk(cin, cbase, stride)]
            cin = cbase * expansion
    sizes.append(("fc", cin * 1000))
    return sizes


def resnet_activation_elems(depth: int, res: int = 224) -> int:
    """Peak live activation elements at inference, batch 1.

    Residual blocks need the block input and the working tensor alive
    at once: 2x the largest feature map (post-stem 64 x (res/2)^2).
    """
    return 2 * 64 * (res // 2) ** 2


def _conv_inventory(depth: int, res: int = 224):
    """((cin, cout, k, hw_out) of every conv, channels into the fc)."""
    blocks, kind = _DEPTHS[depth]
    convs = [(3, 64, 7, res // 2)]
    cin, hw = 64, res // 4
    for stage, (n, cbase) in enumerate(zip(blocks, [64, 128, 256, 512])):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            hw = hw // stride
            if kind == "basic":
                convs += [(cin, cbase, 3, hw), (cbase, cbase, 3, hw)]
                cout = cbase
            else:
                cout = cbase * 4
                convs += [(cin, cbase, 1, hw), (cbase, cbase, 3, hw),
                          (cbase, cout, 1, hw)]
            if stride != 1 or cin != cout:
                convs.append((cin, cout, 1, hw))
            cin = cout
    return convs, cin


def resnet_mults(depth: int, res: int = 224, K: Optional[int] = None) -> int:
    """Multiplications for one inference (paper: K mults/output vs I)."""
    from repro_torch.core.memory import affine_mults, conv_mults
    convs, cfinal = _conv_inventory(depth, res)
    total = sum(conv_mults(co, ci, k, k, hw, hw, K) for ci, co, k, hw in convs)
    return total + affine_mults(1000, cfinal, K)


# ---------------------------------------------------------------------------
# trainable CIFAR-style ResNet-20
# ---------------------------------------------------------------------------

class Node(nn.Module):
    """One dict level of the reference's tree: its children by key."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


def _bn(width: int, dtype, device):
    p, s = init_bn(width, dtype=dtype, device=device)
    return Node(p=BNAffine(p)), s


def init_resnet20(generator: Optional[torch.Generator], *,
                  widths=(16, 32, 64), blocks: int = 2, n_classes: int = 8,
                  dtype=torch.float32, device="cuda"
                  ) -> Tuple[Node, Dict[str, BNStats]]:
    """ResNet-20 family: stem + 3 stages x ``blocks`` basic blocks + fc.

    Returns (model, {name: BNStats}). Draws come from the CPU
    ``generator`` in the reference's order (one draw a conv, then the
    fc) and move to ``device``, so one seed gives the same weights on
    every device; ``device="meta"`` (generator None) builds an unfilled
    skeleton. ``blocks=3`` is ResNet-20 proper (6 * 3 + 2 layers).
    """
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    stem_bn, s = _bn(widths[0], **kw)
    model = Node(stem=conv_init(generator, 3, 3, 3, widths[0], **kw),
                 stem_bn=stem_bn)
    stats = {"stem_bn": s}
    cin = widths[0]
    for si, w in enumerate(widths):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si}b{bi}"
            conv1 = conv_init(generator, 3, 3, cin, w, **kw)
            bn1, s1 = _bn(w, **kw)
            conv2 = conv_init(generator, 3, 3, w, w, **kw)
            bn2, s2 = _bn(w, **kw)
            blk = Node(conv1=conv1, bn1=bn1, conv2=conv2, bn2=bn2)
            stats[f"{name}_bn1"], stats[f"{name}_bn2"] = s1, s2
            if stride != 1 or cin != w:
                blk.down = conv_init(generator, 1, 1, cin, w, **kw)
            setattr(model, name, blk)
            cin = w
    fc = normal(generator, (cin, n_classes), dev) * (cin ** -0.5)
    model.fc = Linear(fc.to(dtype))
    return model, stats


def resnet20_apply(model: Node, stats: Dict[str, BNStats], x: torch.Tensor,
                   *, widths=(16, 32, 64), blocks: int = 2,
                   training: bool = False, multiplier_less: bool = False,
                   act_bits: int = 32):
    """Returns (logits, new_stats). ``x``: (B, H, W, 3) NHWC.

    Under ``multiplier_less`` at inference each BN is folded to ``(a,
    b)`` with an exact pow2 ``a`` and applied as a sign flip, shift and
    add (:func:`repro_torch.core.mlbn.apply_scale_offset_shift`). The fc
    goes through ``nn.linear.dot_kernel``, so a serve-form fc runs the
    LUT-Q GEMM kernels.
    """
    new_stats: Dict[str, BNStats] = {}

    def bn(node, s_key, h):
        p = node.p.params
        if multiplier_less and not training:
            a, b = inference_scale_offset(p, stats[s_key],
                                          multiplier_less=True)
            new_stats[s_key] = stats[s_key]
            return apply_scale_offset_shift(h, a, b)
        y, ns = batch_norm(h, p, stats[s_key], training=training,
                           multiplier_less=multiplier_less)
        new_stats[s_key] = ns
        return y

    def act(h):
        return relu_fake_quant(h, act_bits)

    h = conv_apply(model.stem, x)
    h = act(bn(model.stem_bn, "stem_bn", h))
    for si in range(len(widths)):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si}b{bi}"
            blk = getattr(model, name)
            idn = h
            y = conv_apply(blk.conv1, h, stride=stride)
            y = act(bn(blk.bn1, f"{name}_bn1", y))
            y = conv_apply(blk.conv2, y)
            y = bn(blk.bn2, f"{name}_bn2", y)
            if hasattr(blk, "down"):
                idn = conv_apply(blk.down, idn, stride=stride)
            h = act(y + idn)
    h = h.mean(dim=(1, 2))
    return dot_kernel(h, leaf(model.fc, "kernel")), new_stats


def classify_loss(model: Node, stats: Dict[str, BNStats], batch, **kw):
    """(mean cross-entropy, (new_stats, accuracy)) of a training forward;
    ``batch``: ``{"x": (B, H, W, 3), "y": (B,) int labels}``."""
    logits, new_stats = resnet20_apply(model, stats, batch["x"],
                                       training=True, **kw)
    labels = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (logz - gold).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, (new_stats, acc)

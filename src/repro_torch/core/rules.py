"""Rule-based mixed-precision quantization policies.

The paper's experiments never quantize uniformly: first/last layers stay
high-precision and per-layer bitwidths are swept (LUT-Q journal version,
arXiv 1911.04951). A :class:`QuantPolicy` expresses this as an ordered
list of :class:`QuantRule`s — each a path pattern over pytree paths
mapped to a :class:`QuantSpec` (or ``None`` to exclude) — resolved with
first-match-wins semantics.

Pattern syntax (matched against ``"/".join(path)``):
  * glob (default): ``fnmatch`` where ``*`` crosses ``/`` — e.g.
    ``*/attn/*`` matches ``layers/attn/q/kernel``; ``*/moe/w*`` matches
    ``layers/moe/wi``.
  * regex: prefix with ``re:`` — e.g. ``re:(^|/)table$`` matches any
    leaf named ``table`` at any depth (``re.search`` semantics).

A bare :class:`QuantSpec` anywhere a policy is accepted auto-wraps as
``uniform(spec)``, reproducing the historical single-knob behavior
bit-identically.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.spec import (
    LUTQ_2BIT_POW2,
    LUTQ_4BIT,
    LUTQ_4BIT_POW2,
    SERVING_POW2,
    TERNARY_SCALED,
    QuantSpec,
    spec_from_dict,
    spec_to_dict,
)


@dataclasses.dataclass(frozen=True)
class QuantRule:
    """One pattern -> spec mapping.

    Attributes:
      pattern: glob (or ``re:``-prefixed regex) over the joined path.
      spec: the QuantSpec to apply, or None to exclude from quantization.
      min_size: per-rule eligibility floor; defaults to spec.min_size.
        Tensors smaller than the floor are left unquantized even when
        the pattern matches (the rule still *claims* the leaf: matching
        stops — first match wins).
      name: id used in reports/serialization; defaults to the pattern.
      backend: serving kernel backend for the matched leaves ('auto' |
        'decode' | 'fused' | 'packed4'); None defers to spec.backend.
        Resolved per leaf by serve_view / kernels.ops.lutq_dot.
    """

    pattern: str
    spec: Optional[QuantSpec]
    min_size: Optional[int] = None
    name: Optional[str] = None
    backend: Optional[str] = None

    def __post_init__(self):
        if self.backend not in (None, "auto", "decode", "fused", "packed4",
                                "pow2"):
            raise ValueError(f"unknown kernel backend {self.backend!r}")

    @property
    def rule_name(self) -> str:
        return self.name if self.name is not None else self.pattern

    @property
    def resolved_backend(self) -> str:
        """Requested backend: rule override > spec.backend > 'auto'."""
        if self.backend is not None:
            return self.backend
        return self.spec.backend if self.spec is not None else "auto"

    def matches(self, path: Tuple[str, ...]) -> bool:
        joined = "/".join(path)
        if self.pattern.startswith("re:"):
            return re.search(self.pattern[3:], joined) is not None
        return fnmatch.fnmatchcase(joined, self.pattern)

    @property
    def size_floor(self) -> int:
        if self.min_size is not None:
            return self.min_size
        return self.spec.min_size if self.spec is not None else 0


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered first-match-wins rule list over pytree paths.

    A leaf claimed by no rule stays unquantized. Hashable (usable inside
    a jit-static ModelConfig) and JSON-serializable (checkpoint
    manifests, ``--quant-policy``).
    """

    rules: Tuple[QuantRule, ...]
    name: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    # -- resolution ---------------------------------------------------------
    def match(self, path: Tuple[str, ...]) -> Optional[int]:
        """Index of the first rule whose pattern matches, else None."""
        for i, rule in enumerate(self.rules):
            if rule.matches(path):
                return i
        return None

    def resolve(self, path: Tuple[str, ...], size: Optional[int] = None
                ) -> Tuple[Optional[int], Optional[QuantSpec]]:
        """(rule_id, spec) for a leaf. spec is None when the leaf stays
        full-precision (no match, exclusion rule, or under the rule's
        size floor)."""
        i = self.match(path)
        if i is None:
            return None, None
        rule = self.rules[i]
        if rule.spec is None:
            return i, None
        if size is not None and size < rule.size_floor:
            return i, None
        return i, rule.spec

    def spec_of(self, rule_id: int) -> Optional[QuantSpec]:
        return self.rules[rule_id].spec

    # -- composition --------------------------------------------------------
    def prepend(self, rule: QuantRule) -> "QuantPolicy":
        return QuantPolicy(rules=(rule,) + self.rules, name=self.name)

    @property
    def specs(self) -> Tuple[QuantSpec, ...]:
        return tuple(r.spec for r in self.rules if r.spec is not None)

    @property
    def is_uniform(self) -> bool:
        return len(self.rules) == 1 and self.rules[0].pattern == "*" \
            and self.rules[0].spec is not None

    def dominant_spec(self) -> Optional[QuantSpec]:
        """Spec of the last spec-carrying rule — by convention the
        catch-all that covers the bulk of the network (used by analytic
        models that need one representative spec)."""
        for rule in reversed(self.rules):
            if rule.spec is not None:
                return rule.spec
        return None

    # -- serialization ------------------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "rules": [
                {"pattern": r.pattern,
                 "spec": None if r.spec is None else spec_to_dict(r.spec),
                 "min_size": r.min_size,
                 "name": r.name,
                 "backend": r.backend}
                for r in self.rules
            ],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @staticmethod
    def from_json_dict(d: Dict[str, Any]) -> "QuantPolicy":
        if "rules" not in d or not isinstance(d["rules"], list):
            raise ValueError("policy JSON needs a 'rules' list")
        rules = []
        for i, r in enumerate(d["rules"]):
            if "pattern" not in r:
                raise ValueError(f"policy rule [{i}] is missing 'pattern': {r}")
            rules.append(
                QuantRule(pattern=r["pattern"],
                          spec=None if r.get("spec") is None
                          else spec_from_dict(r["spec"]),
                          min_size=r.get("min_size"),
                          name=r.get("name"),
                          backend=r.get("backend")))
        return QuantPolicy(rules=tuple(rules), name=d.get("name", "custom"))

    @staticmethod
    def from_json(s: str) -> "QuantPolicy":
        return QuantPolicy.from_json_dict(json.loads(s))

    def describe(self) -> str:
        lines = [f"QuantPolicy {self.name!r}:"]
        for i, r in enumerate(self.rules):
            if r.spec is None:
                rhs = "fp (excluded)"
            else:
                rhs = (f"{r.spec.bits}-bit/{r.spec.constraint}"
                       f" (K={r.spec.K}, min_size={r.size_floor})")
            if r.resolved_backend != "auto":
                rhs += f" [{r.resolved_backend}]"
            if r.spec is not None and r.spec.act_bits < 32:
                rhs += (f" act{r.spec.act_bits}"
                        f"{'-frozen' if r.spec.act_frozen else ''}")
            lines.append(f"  [{i}] {r.rule_name:24s} {r.pattern:20s} -> {rhs}")
        return "\n".join(lines)


QuantLike = Union[QuantSpec, QuantPolicy]


def as_policy(quant: Optional[QuantLike]) -> Optional[QuantPolicy]:
    """Normalize a QuantSpec | QuantPolicy | None to a policy (or None)."""
    if quant is None or isinstance(quant, QuantPolicy):
        return quant
    if isinstance(quant, QuantSpec):
        return uniform(quant)
    raise TypeError(f"expected QuantSpec or QuantPolicy, got {type(quant)}")


# ---------------------------------------------------------------------------
# named presets
# ---------------------------------------------------------------------------

# Leaves named `table` (embeddings / tied softmax) at any depth, and the
# untied output head. These are the paper's "first/last layer" set.
EMBED_PATTERN = "re:(^|/)table$"
HEAD_PATTERN = "lm_head/*"


def with_size_floor(policy: QuantPolicy, min_size: int) -> QuantPolicy:
    """``policy`` with every quantizing rule's eligibility floor at
    ``min_size`` (excluding rules unchanged): a reduced config whose
    leaves are under a preset's floor still quantizes them all."""
    return QuantPolicy(rules=tuple(
        r if r.spec is None else dataclasses.replace(r, min_size=min_size)
        for r in policy.rules), name=policy.name)


def uniform(spec: QuantSpec, name: str = "uniform") -> QuantPolicy:
    """Single catch-all rule: exactly the historical global-QuantSpec
    behavior (same eligibility predicate, same min_size floor)."""
    return QuantPolicy(rules=(QuantRule("*", spec, name="all"),), name=name)


def paper_default(spec: QuantSpec = LUTQ_4BIT_POW2) -> QuantPolicy:
    """Quantize the body, keep first/last layers full-precision — the
    configuration every experiment table in the paper actually uses."""
    return QuantPolicy(
        rules=(QuantRule(EMBED_PATTERN, None, name="first-layer-fp"),
               QuantRule(HEAD_PATTERN, None, name="last-layer-fp"),
               QuantRule("*", spec, name="body")),
        name="paper_default")


def serving_aggressive() -> QuantPolicy:
    """Serving-footprint preset: fp embeddings, 4-bit attention,
    2-bit-pow2 MLP/MoE, 4-bit-pow2 everything else."""
    return QuantPolicy(
        rules=(QuantRule(EMBED_PATTERN, None, name="embed-fp"),
               QuantRule(HEAD_PATTERN, None, name="head-fp"),
               QuantRule("*/attn/*", LUTQ_4BIT, name="attn-4bit"),
               QuantRule("*/mlp/*", LUTQ_2BIT_POW2, name="mlp-2bit-pow2"),
               QuantRule("*/moe/*", LUTQ_2BIT_POW2, name="moe-2bit-pow2"),
               QuantRule("*", LUTQ_4BIT_POW2, name="rest-4bit-pow2")),
        name="serving_aggressive")


def mixed_paper() -> QuantPolicy:
    """The acceptance-criteria mix: fp embeddings + excluded first/last
    layers, 4-bit-pow2 attention, 2-bit ternary MLPs."""
    return QuantPolicy(
        rules=(QuantRule(EMBED_PATTERN, None, name="first-layer-fp"),
               QuantRule(HEAD_PATTERN, None, name="last-layer-fp"),
               QuantRule("*/attn/*", LUTQ_4BIT_POW2, name="attn-4bit-pow2"),
               QuantRule("*/mlp/*", TERNARY_SCALED, name="mlp-ternary"),
               QuantRule("*/moe/*", TERNARY_SCALED, name="moe-ternary"),
               QuantRule("*", LUTQ_4BIT_POW2, name="rest-4bit-pow2")),
        name="mixed_paper")


def serving_pow2() -> QuantPolicy:
    """Multiplier-less deployment: fp embeddings/head, everything else a
    pow2 dictionary served as sign+exponent planes through the shift-add
    kernel with int8 activations at calibration-frozen scales (paper
    headline + Appendix A; see docs/multiplierless.md)."""
    return QuantPolicy(
        rules=(QuantRule(EMBED_PATTERN, None, name="first-layer-fp"),
               QuantRule(HEAD_PATTERN, None, name="last-layer-fp"),
               QuantRule("*", SERVING_POW2, name="body-pow2-shift")),
        name="serving_pow2")


PRESETS = {
    "paper_default": paper_default,
    "serving_aggressive": serving_aggressive,
    "mixed_paper": mixed_paper,
    "serving_pow2": serving_pow2,
}


def get_policy(name_or_json: str) -> QuantPolicy:
    """Resolve a --quant-policy CLI value: preset name, ``uniform:<bits>
    [:<constraint>]``, inline JSON, or an ``@file.json`` path."""
    s = name_or_json.strip()
    if s in PRESETS:
        return PRESETS[s]()
    if s.startswith("uniform:"):
        parts = s.split(":")
        bits = int(parts[1])
        constraint = parts[2] if len(parts) > 2 else "none"
        return uniform(QuantSpec(bits=bits, constraint=constraint),
                       name=f"uniform{bits}")
    if s.startswith("@"):
        with open(s[1:]) as f:
            return QuantPolicy.from_json(f.read())
    if s.startswith("{"):
        return QuantPolicy.from_json(s)
    raise ValueError(
        f"unknown quant policy {name_or_json!r}; expected one of "
        f"{sorted(PRESETS)}, 'uniform:<bits>[:<constraint>]', inline JSON, "
        f"or @path/to/policy.json")

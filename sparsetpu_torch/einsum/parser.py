"""Einsum spec parser with the reference's validation semantics: a copy of
``sparsetpu/einsum/parser.py`` (pure Python).

Reference: einsum-dyn/src/lib.rs:172-357 and linalg/src/einsum.rs:45-202 —
specs like ``"ab,bc->ac"``, multi-output ``"ab,bc->ac,ca"``, repeated letters
within an input denote diagonals, contraction letters are those absent from
the output(s).  The 10-variant InvalidSpec error enum becomes
:class:`InvalidSpec` with a ``kind`` tag.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


class InvalidSpec(ValueError):
    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class EinsumSpec:
    inputs: Tuple[Tuple[str, ...], ...]
    outputs: Tuple[Tuple[str, ...], ...]

    @property
    def slots(self) -> List[str]:
        """All distinct letters in first-appearance order."""
        seen: List[str] = []
        for inp in self.inputs:
            for ch in inp:
                if ch not in seen:
                    seen.append(ch)
        return seen

    @property
    def free(self) -> List[str]:
        out_letters = {ch for out in self.outputs for ch in out}
        return [s for s in self.slots if s in out_letters]

    @property
    def contracted(self) -> List[str]:
        out_letters = {ch for out in self.outputs for ch in out}
        return [s for s in self.slots if s not in out_letters]

    def canonical(self) -> str:
        return (
            ",".join("".join(i) for i in self.inputs)
            + "->"
            + ",".join("".join(o) for o in self.outputs)
        )


def parse_spec(spec: str) -> EinsumSpec:
    if not spec:
        raise InvalidSpec("Empty", "empty spec")
    if "->" not in spec:
        raise InvalidSpec("NoArrow", f"missing '->' in {spec!r}")
    if spec.count("->") > 1:
        raise InvalidSpec("MultipleArrows", f"more than one '->' in {spec!r}")
    lhs, rhs = spec.split("->")
    if not lhs:
        raise InvalidSpec("NoInputs", "no inputs before '->'")
    input_parts = lhs.split(",")
    output_parts = rhs.split(",") if rhs else [""]

    def check_chars(part: str, where: str):
        for ch in part:
            if not ("a" <= ch <= "z"):
                raise InvalidSpec("BadChar", f"invalid char {ch!r} in {where}")

    inputs = []
    for p in input_parts:
        if p == "":
            raise InvalidSpec("EmptyInput", f"empty input operand in {spec!r}")
        check_chars(p, "input")
        inputs.append(tuple(p))

    in_letters = {ch for p in inputs for ch in p}
    outputs = []
    for p in output_parts:
        check_chars(p, "output")
        if len(set(p)) != len(p):
            raise InvalidSpec("RepeatedOutputIndex", f"repeated index in output {p!r}")
        for ch in p:
            if ch not in in_letters:
                raise InvalidSpec(
                    "OutputIndexNotInInput", f"output index {ch!r} not in any input"
                )
        outputs.append(tuple(p))

    return EinsumSpec(inputs=tuple(inputs), outputs=tuple(outputs))


def validate_dims(spec: EinsumSpec, shapes: Sequence[Tuple[int, ...]]) -> Dict[str, int]:
    """Check rank and dimension consistency; returns letter -> size map
    (reference dim-consistency validation, linalg/src/einsum.rs:259-286)."""
    if len(shapes) != len(spec.inputs):
        raise InvalidSpec(
            "WrongOperandCount",
            f"spec has {len(spec.inputs)} inputs, got {len(shapes)} operands",
        )
    dims: Dict[str, int] = {}
    for inp, shape in zip(spec.inputs, shapes):
        if len(inp) != len(shape):
            raise InvalidSpec(
                "RankMismatch", f"input {''.join(inp)!r} vs shape {shape}"
            )
        for ch, d in zip(inp, shape):
            if ch in dims and dims[ch] != d:
                raise InvalidSpec(
                    "DimMismatch", f"index {ch!r}: {dims[ch]} vs {d}"
                )
            dims[ch] = d
    return dims

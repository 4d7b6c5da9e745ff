"""Scalar programs: the scalar algebra's ops recorded once on symbolic
columns, then evaluated again on tensors or emitted as C++ statements.

The engine's hot path (``dynamics._step_parts`` and the per-pair anchored
loops of ``contact``) is written on lists of [E] columns and Python floats;
each op it issues on a column is elementwise. Running it once on ``Sym``
columns in place of tensors records that op list, one entry per op, with
the Python floats folded exactly as they fold on tensors (a structural zero
issues no op here either). The list is the program a kernel with one thread
per env runs:

- ``Program.run`` evaluates it on tensors with the same torch calls the
  eager step makes, in the same order (the reference interpreter the tests
  hold against the eager step);
- ``Program.emit`` writes it as one C++ function of scalar floats, one
  statement per op, each rounding as the torch op does (fp32; Python
  floats become fp32 literals, as torch casts a Python scalar to the
  tensor's dtype; compiled without FMA contraction).

``Sym`` catches Python's operators and, through ``__torch_function__``,
the torch functions the algebra calls. An op with no lowering here raises,
as does a branch on a symbolic value (``bool``) or a real tensor met
during the trace, so no part of a step is left out silently.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

FLOAT, BOOL = "float", "bool"

# torch function -> op name; each op's torch call is what ``run`` makes
_UNARY = {
    torch.sqrt: "sqrt",
    torch.sin: "sin",
    torch.cos: "cos",
    torch.arcsin: "asin",
    torch.reciprocal: "recip",
    torch.abs: "abs",
    torch.sign: "sign",
    torch.isfinite: "isfinite",
}
_BINARY = {torch.minimum: "minimum"}
_CLAMPS = {torch.clamp: "clamp", torch.clamp_min: "clamp_min", torch.clamp_max: "clamp_max"}

# op name -> the call ``run`` makes on tensors and Python floats
_EVAL = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "div": operator.truediv,
    "neg": operator.neg, "sq": lambda a: a**2,
    "gt": operator.gt, "lt": operator.lt, "ge": operator.ge,
    "and": operator.and_, "or": operator.or_, "not": operator.invert,
    "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos, "asin": torch.arcsin,
    "recip": torch.reciprocal, "abs": torch.abs, "sign": torch.sign, "isfinite": torch.isfinite,
    "minimum": torch.minimum,
    "clamp": torch.clamp, "clamp_min": torch.clamp_min, "clamp_max": torch.clamp_max,
    "where": torch.where,
}
_BOOL_OPS = {"gt", "lt", "ge", "and", "or", "not", "isfinite"}

# op name -> C++ expression over the operands' names
_C = {
    "add": "{0} + {1}", "sub": "{0} - {1}", "mul": "{0} * {1}", "div": "{0} / {1}", "neg": "-{0}",
    "sq": "{0} * {0}", "gt": "{0} > {1}", "lt": "{0} < {1}", "ge": "{0} >= {1}",
    "and": "{0} && {1}", "or": "{0} || {1}", "not": "!{0}",
    "sqrt": "sqrtf({0})", "sin": "sinf({0})", "cos": "cosf({0})", "asin": "asinf({0})",
    "recip": "1.0f / {0}", "abs": "fabsf({0})", "sign": "pql_sign({0})", "isfinite": "pql_isfinite({0})",
    "minimum": "pql_minimum({0}, {1})",
    "clamp": "pql_clamp({0}, {1}, {2})", "clamp_min": "pql_clamp_min({0}, {1})",
    "clamp_max": "pql_clamp_max({0}, {1})", "where": "{0} ? {1} : {2}",
}


class Sym:
    """One symbolic [E] column: the result of op ``id`` of ``prog``."""

    __slots__ = ("prog", "id", "kind")

    def __init__(self, prog: Program, id: int, kind: str):
        self.prog, self.id, self.kind = prog, id, kind

    def _op(self, name, *args):
        return self.prog.op(name, *args)

    def __add__(self, o):
        return self._op("add", self, o)

    def __radd__(self, o):
        return self._op("add", o, self)

    def __sub__(self, o):
        return self._op("sub", self, o)

    def __rsub__(self, o):
        return self._op("sub", o, self)

    def __mul__(self, o):
        return self._op("mul", self, o)

    def __rmul__(self, o):
        return self._op("mul", o, self)

    def __truediv__(self, o):
        return self._op("div", self, o)

    def __neg__(self):
        return self._op("neg", self)

    def __pow__(self, e):
        if isinstance(e, bool) or e != 2:
            raise NotImplementedError(f"codegen: no lowering for x ** {e!r} (only x ** 2)")
        return self._op("sq", self)

    def __gt__(self, o):
        return self._op("gt", self, o)

    def __lt__(self, o):
        return self._op("lt", self, o)

    def __ge__(self, o):
        return self._op("ge", self, o)

    def __and__(self, o):
        return self._op("and", self, o)

    def __or__(self, o):
        return self._op("or", self, o)

    def __invert__(self):
        return self._op("not", self)

    def __bool__(self):
        raise TypeError("codegen: a branch on a symbolic column (each env takes its own; use torch.where)")

    __float__ = __int__ = __index__ = __bool__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prog = next(a.prog for a in (*args, *kwargs.values()) if isinstance(a, Sym))
        if func in _UNARY and len(args) == 1 and not kwargs:
            return prog.op(_UNARY[func], args[0])
        if func in _BINARY and len(args) == 2 and not kwargs:
            return prog.op(_BINARY[func], *args)
        if func in _CLAMPS and not kwargs:
            return prog.clamp(_CLAMPS[func], *args)
        if func is torch.where and len(args) == 3 and not kwargs:
            return prog.op("where", *args)
        if func is torch.full_like and len(args) == 2 and not kwargs:
            return prog.full(args[1])
        raise NotImplementedError(f"codegen: no C lowering for {getattr(func, '__name__', func)}")


def _is_const(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


class Program:
    """The op list of one traced function. Each op is (name, args), args
    ``Sym``s of this program or Python numbers; ``inputs`` and ``outputs``
    are named groups of columns, in order."""

    def __init__(self):
        self.ops: list[tuple[str, tuple]] = []
        self.kinds: list[str] = []
        self.inputs: dict[str, list[Sym]] = {}
        self.outputs: dict[str, list] = {}

    # ------------------------------------------------------------ recording

    def _new(self, name: str, args: tuple, kind: str) -> Sym:
        self.ops.append((name, args))
        self.kinds.append(kind)
        return Sym(self, len(self.ops) - 1, kind)

    def input(self, group: str, n: int) -> list[Sym]:
        """n fresh float columns, read as ``group[0..n)``."""
        cols = [self._new("in", (group, k), FLOAT) for k in range(n)]
        self.inputs[group] = cols
        return cols

    def _check(self, a):
        if isinstance(a, Sym):
            if a.prog is not self:
                raise ValueError("codegen: a column of another program")
            return a
        if _is_const(a):
            if np.isnan(a):
                raise ValueError("codegen: a NaN constant")
            return a
        raise TypeError(f"codegen: cannot record an operand of type {type(a).__name__} (a real tensor met "
                        "during the trace, or a value the lowering does not know)")

    def op(self, name: str, *args) -> Sym:
        args = tuple(self._check(a) for a in args)
        if not any(isinstance(a, Sym) for a in args):
            raise TypeError(f"codegen: {name} of constants only")
        kinds = [a.kind for a in args if isinstance(a, Sym)]
        if name in ("and", "or", "not"):
            if any(k != BOOL for k in kinds) or any(_is_const(a) for a in args):
                raise TypeError(f"codegen: {name} takes boolean columns")
        elif name == "where":
            if not isinstance(args[0], Sym) or args[0].kind != BOOL or any(
                    isinstance(a, Sym) and a.kind != FLOAT for a in args[1:]):
                raise TypeError("codegen: where(bool column, float, float)")
        elif all(k == BOOL for k in kinds):
            raise TypeError(f"codegen: {name} of boolean columns only")
        return self._new(name, args, BOOL if name in _BOOL_OPS else FLOAT)

    def clamp(self, name: str, x, *bounds) -> Sym:
        """``torch.clamp(x, lo, hi)``, ``clamp_min(x, lo)``, ``clamp_max(x, hi)``
        with bounds that are Python numbers."""
        if len(bounds) != (2 if name == "clamp" else 1) or not all(_is_const(b) for b in bounds):
            raise NotImplementedError(f"codegen: {name} takes bounds that are Python numbers, got {bounds}")
        return self.op(name, x, *bounds)

    def full(self, value) -> Sym:
        """A column filled with ``value`` (``torch.full_like``); a column stays itself."""
        if isinstance(value, Sym):
            return value
        self._check(value)
        return self._new("const", (value,), FLOAT)

    def output(self, group: str, cols) -> None:
        self.outputs[group] = [self._check(c) for c in cols]

    # ------------------------------------------------------------ analysis

    def live(self) -> list[bool]:
        """Which ops an output depends on (the rest are dead: a value the
        step computes and never uses)."""
        keep = [False] * len(self.ops)
        stack = [c.id for cols in self.outputs.values() for c in cols if isinstance(c, Sym)]
        while stack:
            i = stack.pop()
            if keep[i]:
                continue
            keep[i] = True
            stack.extend(a.id for a in self.ops[i][1] if isinstance(a, Sym))
        return keep

    def op_count(self) -> int:
        """Live ops that compute (inputs and constants aside): the statements
        of arithmetic the emitted function holds, one per op."""
        return sum(k and self.ops[i][0] not in ("in", "const") for i, k in enumerate(self.live()))

    # ------------------------------------------------------------ evaluation

    def run(self, inputs: dict[str, list[torch.Tensor]]) -> dict[str, list]:
        """Evaluate on [E] tensors (``inputs``: a list of columns per input
        group) with the torch call each op recorded: the eager step's own
        calls, in its order. Returns the output groups as lists of columns."""
        ref = next(iter(inputs.values()))[0]
        vals: list = [None] * len(self.ops)
        val = lambda a: vals[a.id] if isinstance(a, Sym) else a  # noqa: E731
        for i, ((name, args), live) in enumerate(zip(self.ops, self.live())):
            if not live:
                continue
            if name == "in":
                vals[i] = inputs[args[0]][args[1]]
            elif name == "const":
                vals[i] = torch.full_like(ref, args[0])
            else:
                vals[i] = _EVAL[name](*(val(a) for a in args))
        return {g: [val(c) for c in cols] for g, cols in self.outputs.items()}

    # ------------------------------------------------------------ emission

    def emit(self, name: str, params: dict[str, str]) -> str:
        """One C++ function ``name`` of scalar floats. ``params`` maps each
        input and output group to its parameter's C++ declaration (a group
        both read and written names one pointer: every read comes before
        the first write). Returns the source."""
        missing = (set(self.inputs) | set(self.outputs)) - set(params)
        if missing:
            raise ValueError(f"codegen: no parameter for {sorted(missing)}")
        live = self.live()
        lines = [f"PQL_DEVICE void {name}({', '.join(params.values())}) {{"]
        sym = lambda a: f"v{a.id}" if isinstance(a, Sym) else _literal(a)  # noqa: E731
        for i, ((op, args), keep) in enumerate(zip(self.ops, live)):
            if not keep:
                continue
            ctype = "bool" if self.kinds[i] == BOOL else "float"
            if op == "in":
                expr = f"{args[0]}[{args[1]}]"
            elif op == "const":
                expr = _literal(args[0])
            else:
                operands = [sym(a) if not (isinstance(a, Sym) and a.kind == BOOL and op not in _BOOL_OPS
                                           and op != "where") else f"float({sym(a)})" for a in args]
                if op == "where":
                    operands[0] = sym(args[0])
                expr = _C[op].format(*operands)
            lines.append(f"  const {ctype} v{i} = {expr};")
        for group, cols in self.outputs.items():
            for k, c in enumerate(cols):
                lines.append(f"  {group}[{k}] = {sym(c)};")
        lines.append("}")
        return "\n".join(lines) + "\n"


def _literal(x) -> str:
    """A Python number as the fp32 C++ literal torch would cast it to."""
    f = np.float32(x)
    if np.isinf(f):
        return "INFINITY" if f > 0 else "-INFINITY"
    return f"{float(f).hex()}f"


def trace(fn, inputs: dict[str, int]) -> tuple[Program, object]:
    """Run ``fn(**columns)`` on symbolic columns: ``inputs`` maps each
    argument to its number of columns. Returns (the program, fn's result,
    whose columns the caller hands to ``Program.output``)."""
    prog = Program()
    cols = {g: prog.input(g, n) for g, n in inputs.items()}
    return prog, fn(**cols)

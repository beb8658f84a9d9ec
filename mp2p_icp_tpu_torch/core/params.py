"""Dynamic parameters: math expressions evaluated at run time.

Port of ``mp2p_icp_tpu/core/params.py`` (reference: Parameterizable.h:51-186):
any numeric module field may be an expression over named variables
(``ICP_ITERATION``, user variables), parsed once into a Python AST and
evaluated against a variable dict.

A variable may be a number or a 0-d tensor. Arithmetic goes through
``operator.*``, so tensors flow through it; a comparison of tensors stays a
tensor and a conditional on a tensor selects with ``torch.where`` (both
arms are evaluated), which is what the JAX package does on a traced value.

The JAX package evaluates ``ICP_ITERATION`` as a traced float32: a Python
number that meets it becomes a float32 constant (JAX's weak typing), and
on its CPU backend XLA fuses a multiply-add such as
``2.0 - 0.1*ICP_ITERATION`` into one operation, rounded once. The port does
the same (``static_value`` of matchers/base.py): ``ICP_ITERATION`` is a
float64 tensor, a Python number is rounded to float32 where it meets a
tensor, and the result is rounded to float32 once, so multiply-adds and
conditionals give the JAX package's float32 to the bit. Forms that XLA
rewrites further (a division by a constant becomes a product with its
reciprocal) may differ in the last bit.
"""

from __future__ import annotations

import ast
import math
import operator
from typing import Any, Dict, Optional

import numpy as np
import torch

_ALLOWED_FUNCS = {
    "abs": abs,
    "sqrt": math.sqrt,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "atan2": math.atan2,
    "exp": math.exp,
    "log": math.log,
    "floor": math.floor,
    "ceil": math.ceil,
    "min": min,
    "max": max,
    "pow": pow,
    "deg2rad": math.radians,
    "rad2deg": math.degrees,
}
_ALLOWED_CONSTS = {"pi": math.pi, "M_PI": math.pi, "e": math.e}

_BINOPS = {
    ast.Add: operator.add,
    ast.Sub: operator.sub,
    ast.Mult: operator.mul,
    ast.Div: operator.truediv,
    ast.Mod: operator.mod,
    ast.Pow: operator.pow,
    ast.FloorDiv: operator.floordiv,
}
_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos}
_CMP = {
    ast.Lt: operator.lt,
    ast.LtE: operator.le,
    ast.Gt: operator.gt,
    ast.GtE: operator.ge,
    ast.Eq: operator.eq,
    ast.NotEq: operator.ne,
}


class Expression:
    """A parsed numeric expression over named variables (no attribute
    access, no calls beyond the allowlist). Hashable and comparable by its
    text, so module configs that hold one stay frozen dataclasses."""

    def __hash__(self):
        return hash(("mp2p_expr", self.text))

    def __eq__(self, other):
        return isinstance(other, Expression) and other.text == self.text

    def __repr__(self):
        return f"Expression({self.text!r})"

    def __init__(self, text: str):
        self.text = text.strip()
        # the reference wraps expressions as '$f{...}' in YAML; accept both
        if self.text.startswith("$f{") and self.text.endswith("}"):
            self.text = self.text[3:-1]
        self._tree = ast.parse(self.text, mode="eval")
        self.variables = sorted(
            {
                n.id
                for n in ast.walk(self._tree)
                if isinstance(n, ast.Name)
                and n.id not in _ALLOWED_FUNCS
                and n.id not in _ALLOWED_CONSTS
            }
        )

    def __call__(self, variables: Optional[Dict[str, Any]] = None):
        return self._eval(self._tree.body, variables or {})

    def _eval(self, node, env):
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, float)):
                raise ValueError(f"non-numeric constant: {node.value!r}")
            return node.value
        if isinstance(node, ast.Name):
            if node.id in _ALLOWED_CONSTS:
                return _ALLOWED_CONSTS[node.id]
            if node.id in env:
                return env[node.id]
            raise KeyError(
                f"undefined variable {node.id!r} in expression {self.text!r}"
            )
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](*_weak(
                self._eval(node.left, env), self._eval(node.right, env)))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY:
            return _UNARY[type(node.op)](self._eval(node.operand, env))
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            left, right = _weak(self._eval(node.left, env),
                                self._eval(node.comparators[0], env))
            res = _CMP[type(node.ops[0])](left, right)
            if isinstance(res, torch.Tensor):
                return res.to(torch.float64)
            return float(res)
        if isinstance(node, ast.IfExp):
            test = self._eval(node.test, env)
            if isinstance(test, torch.Tensor):
                # a tensor condition: both arms, then select
                def arm(n):
                    return torch.as_tensor(_weak(self._eval(n, env), test)[0],
                                           dtype=torch.float64, device=test.device)

                return torch.where(test.to(torch.bool), arm(node.body), arm(node.orelse))
            return self._eval(node.body, env) if test else self._eval(node.orelse, env)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fn = _ALLOWED_FUNCS.get(node.func.id)
            if fn is None:
                raise ValueError(f"function not allowed: {node.func.id}")
            return fn(*(self._eval(a, env) for a in node.args))
        raise ValueError(
            f"unsupported syntax in expression {self.text!r}: {ast.dump(node)}"
        )


def _weak(a, b):
    """A Python float that meets a tensor as the float32 constant that JAX's
    weak typing makes of it."""
    def f32(x, other):
        if isinstance(x, float) and isinstance(other, torch.Tensor):
            return float(np.float32(x))
        return x

    return f32(a, b), f32(b, a)


def iteration_env(iteration) -> Dict[str, torch.Tensor]:
    """``{"ICP_ITERATION": it}`` with ``it`` a float64 0-d tensor: on the
    CPU for a host count, or the given tensor (a per-problem count under
    ``torch.func.vmap``) converted."""
    if isinstance(iteration, torch.Tensor):
        return {"ICP_ITERATION": iteration.to(torch.float64)}
    return {"ICP_ITERATION": torch.tensor(float(iteration), dtype=torch.float64)}


def resolve_value(value, variables: Optional[Dict[str, Any]] = None):
    """YAML scalar -> number. Strings are parsed as expressions (constant
    folding when they reference no unknown variables)."""
    if isinstance(value, (int, float, bool)):
        return value
    if isinstance(value, str):
        return Expression(value)(variables)
    raise TypeError(f"cannot resolve parameter value: {value!r}")


class ParameterSource:
    """Named-variable store attached to parameterised modules
    (reference: ParameterSource, Parameterizable.h:93-150)."""

    def __init__(self):
        self._vars: Dict[str, float] = {}

    def update_variable(self, name: str, value: float) -> None:
        self._vars[name] = float(value)

    def update_variables(self, d: Dict[str, float]) -> None:
        for k, v in d.items():
            self.update_variable(k, v)

    @property
    def variables(self) -> Dict[str, float]:
        return dict(self._vars)

    def realize(self, expr: Expression) -> float:
        return expr(self._vars)

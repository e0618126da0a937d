from .expr import (
    BinOp,
    Const,
    Expr,
    FuncRef,
    IterVal,
    Select,
    count_ops,
    eval_expr,
    expr_depth,
    maximum,
    minimum,
)
from .func import Func, RDom, Var
from .lower import Pipeline, Stage, execute_pipeline, lower_pipeline

__all__ = [
    "BinOp",
    "Const",
    "Expr",
    "FuncRef",
    "IterVal",
    "Select",
    "count_ops",
    "eval_expr",
    "expr_depth",
    "maximum",
    "minimum",
    "Func",
    "RDom",
    "Var",
    "Pipeline",
    "Stage",
    "execute_pipeline",
    "lower_pipeline",
]

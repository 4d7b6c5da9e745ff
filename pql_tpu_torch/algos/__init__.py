"""Algorithms of the port: PQL / PQL-D on one device."""

from pql_tpu_torch.algos.pql import PQL, PQLState

__all__ = ["PQL", "PQLState"]

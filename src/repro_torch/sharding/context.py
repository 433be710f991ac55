"""Activation-sharding context — the port of ``repro.sharding.context``.

Model code annotates tensors by logical name (``constraint(x, "act_btd")``)
and stays mesh-agnostic; a launcher installs a rules table mapping logical
names to ``PartitionSpec``s.  With no rules installed ``constraint`` is the
identity, which is the only state the data-parallel path has (the
reference's SPMD step installs none either).  Placing an activation by a
rule is the jit partitioner's half, ROADMAP A18b: with rules installed
``constraint`` raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from .partition import A18B, PartitionSpec

_state = threading.local()


def current_rules() -> Optional[Dict[str, PartitionSpec]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[Dict[str, PartitionSpec]]):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constraint(x, name: str):
    """``x`` when no rule names it; a rule that does raises (A18b)."""
    rules = current_rules()
    if rules is None or name not in rules:
        return x
    raise NotImplementedError(f"constraint({name!r}): {A18B}")

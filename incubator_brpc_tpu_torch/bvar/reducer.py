"""Reducers: Adder/Maxer/Miner (reference src/bvar/reducer.h), and PassiveStatus.

Write path is thread-local (one agent per writer thread, found via a
threading.local) — the reference's AgentGroup/AgentCombiner design
(detail/agent_group.h, detail/combiner.h): ``<<`` only touches this thread's
slot; ``get_value()`` walks all agents and combines.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from incubator_brpc_tpu_torch.bvar.variable import Variable


class _Agent:
    __slots__ = ("value",)

    def __init__(self, identity):
        self.value = identity


class Reducer(Variable):
    def __init__(
        self,
        op: Callable,
        identity,
        inv_op: Optional[Callable] = None,
        name: Optional[str] = None,
    ) -> None:
        self._op = op
        self._identity = identity
        self._inv_op = inv_op  # enables Window sampling (reference: sampler on InvOp reducers)
        self._tls = threading.local()
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        super().__init__(name)

    def _agent(self) -> _Agent:
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = _Agent(self._identity)
            with self._agents_lock:
                self._agents.append(agent)
            self._tls.agent = agent
        return agent

    def __lshift__(self, value) -> "Reducer":
        agent = self._agent()
        agent.value = self._op(agent.value, value)
        return self

    def get_value(self):
        with self._agents_lock:
            agents = list(self._agents)
        result = self._identity
        for a in agents:
            result = self._op(result, a.value)
        return result


class Adder(Reducer):
    """bvar::Adder<T> (reducer.h:67) — wait-free per-thread adds."""

    def __init__(self, name: Optional[str] = None, identity=0):
        super().__init__(lambda a, b: a + b, identity, inv_op=lambda a, b: a - b, name=name)


class Maxer(Reducer):
    """bvar::Maxer<T> (reducer.h:223)."""

    def __init__(self, name: Optional[str] = None, identity=float("-inf")):
        super().__init__(max, identity, name=name)


class Miner(Reducer):
    """bvar::Miner<T>."""

    def __init__(self, name: Optional[str] = None, identity=float("inf")):
        super().__init__(min, identity, name=name)


class PassiveStatus(Variable):
    """Value computed on read (reference src/bvar/passive_status.h)."""

    def __init__(self, fn: Callable[[], object], name: Optional[str] = None):
        self._fn = fn
        super().__init__(name)

    def get_value(self):
        return self._fn()

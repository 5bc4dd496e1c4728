"""Variable base + expose registry (reference src/bvar/variable.h:97-204)."""

from __future__ import annotations

import threading
from typing import Dict, Optional


class ExposeRegistry:
    """Global name -> Variable registry behind ``expose()``/``dump_exposed()``.

    The reference shards this map 32 ways to cut lock contention
    (variable.cpp); exposure is a cold path here so one lock suffices.
    """

    def __init__(self) -> None:
        self._vars: Dict[str, "Variable"] = {}
        self._lock = threading.Lock()

    def expose(self, name: str, var: "Variable") -> bool:
        name = normalize_name(name)
        with self._lock:
            if name in self._vars:
                return False
            self._vars[name] = var
            var._exposed_name = name
            return True

    def hide(self, name: str) -> bool:
        with self._lock:
            return self._vars.pop(name, None) is not None

    def describe(self, name: str) -> Optional[str]:
        with self._lock:
            var = self._vars.get(name)
        return None if var is None else var.describe()

    def snapshot(self, prefix: str = ""):
        """Sorted (name, var) pairs at this instant — the exporter-facing
        iteration (builtin/prometheus.py); callers treat vars as read-only."""
        with self._lock:
            items = sorted(self._vars.items())
        if prefix:
            items = [(n, v) for n, v in items if n.startswith(prefix)]
        return items

    def dump(self, prefix: str = "") -> Dict[str, str]:
        with self._lock:
            items = list(self._vars.items())
        return {
            name: var.describe()
            for name, var in sorted(items)
            if name.startswith(prefix)
        }


def normalize_name(name: str) -> str:
    """Lower-snake normalization, as reference to_underscored_name
    (variable.cpp): letters lowered, non-alnum -> '_'."""
    out = []
    prev_us = False
    for ch in name:
        if ch.isalnum():
            if ch.isupper() and out and not prev_us:
                out.append("_")
            out.append(ch.lower())
            prev_us = False
        else:
            if not prev_us and out:
                out.append("_")
            prev_us = True
    return "".join(out).strip("_")


expose_registry = ExposeRegistry()


def dump_exposed(prefix: str = "") -> Dict[str, str]:
    return expose_registry.dump(prefix)


class Variable:
    """Base of all bvars; subclasses implement get_value()/describe()."""

    def __init__(self, name: Optional[str] = None) -> None:
        self._exposed_name: Optional[str] = None
        if name:
            self.expose(name)

    def expose(self, name: str) -> bool:
        # Re-exposing under a new name first drops the old registry entry
        # (the reference re-registers in Variable::expose_impl); otherwise
        # the old entry would pin this Variable in the registry forever.
        if self._exposed_name is not None:
            self.hide()
        return expose_registry.expose(name, self)

    def hide(self) -> bool:
        if self._exposed_name is None:
            return False
        ok = expose_registry.hide(self._exposed_name)
        self._exposed_name = None
        return ok

    def name(self) -> Optional[str]:
        return self._exposed_name

    def get_value(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def describe(self) -> str:
        return str(self.get_value())

    def __del__(self):
        try:
            self.hide()
        except Exception:
            pass

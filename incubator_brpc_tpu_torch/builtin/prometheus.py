"""Prometheus/OpenMetrics exposition of every exposed bvar (reference
src/brpc/builtin/prometheus_metrics_service.cpp: DumpPrometheusMetricsToIOBuf
walks the bvar registry and renders text exposition format, served at
/brpc_metrics).

Type mapping (the reference maps bvar kinds the same way):

  Adder (monotone-by-convention counters)            -> ``counter``
  PassiveStatus / Window / PerSecond / IntRecorder /
  Maxer / Miner / unknown numeric Variables          -> ``gauge``
  LatencyRecorder (and anything quantile-bearing)    -> ``summary`` with
      {quantile="0.5|0.9|0.99|0.999"} sample lines plus ``_sum``/``_count``,
      and companion ``_max_latency`` / ``_qps`` gauges (the reference
      renders LatencyRecorder's window bvars as exactly this family).

Numeric flags are mirrored as ``flag_<name>`` gauges — the same rows /vars
serves (the reference registers every gflag as a bvar, so its exposition
carries them too). Non-numeric values (string PassiveStatus, dict-valued
describe()s) are skipped: Prometheus samples are floats.

The port's copy of the JAX package's ``builtin/prometheus.py``; the native
plane registers its telemetry drain as a scrape hook.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional

from incubator_brpc_tpu_torch.bvar.recorder import IntRecorder, LatencyRecorder
from incubator_brpc_tpu_torch.bvar.reducer import Adder, Maxer, Miner, PassiveStatus
from incubator_brpc_tpu_torch.bvar.variable import expose_registry
from incubator_brpc_tpu_torch.bvar.window import Window

# quantiles rendered for every summary (latency_recorder.h's percentile set)
SUMMARY_QUANTILES = (0.5, 0.9, 0.99, 0.999)

# Pre-scrape hooks: callables run (exception-safe) before every exposition
# render so lazily-aggregated sources flush into their bvars first — the
# native plane's telemetry ring registers its forced drain here, making a
# scrape see completions recorded microseconds ago instead of a drain
# interval ago.
_scrape_hooks: list = []


def register_scrape_hook(fn) -> None:
    if fn not in _scrape_hooks:
        _scrape_hooks.append(fn)


def unregister_scrape_hook(fn) -> None:
    try:
        _scrape_hooks.remove(fn)
    except ValueError:
        pass


def run_scrape_hooks() -> None:
    """Flush every lazily-aggregated source into its bvars (exception-
    safe). render_metrics runs this itself; the /vars family calls it
    too so both read surfaces see equally fresh values."""
    for hook in list(_scrape_hooks):
        try:
            hook()
        except Exception:
            pass  # a wedged source must not kill the scrape

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# metric names must match [a-zA-Z_:][a-zA-Z0-9_:]* — bvar names are already
# lower_snake (variable.normalize_name) but may start with a digit
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    name = _BAD_CHARS.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def escape_label_value(value: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double-quote and newline must be escaped inside ``label="..."``."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(value) -> Optional[str]:
    """Render one sample value, or None when it is not a number (skipped —
    exposition samples are float64)."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if math.isnan(value):
            return "NaN"
        return repr(value)
    return None


def _emit_summary(out: List[str], mname: str, var) -> None:
    """LatencyRecorder family: quantile samples + _sum/_count, and the
    companion max/qps gauges the reference exposes alongside. Built in a
    local block so a recorder that raises mid-read leaves no partial
    summary in the exposition (the caller skips it whole)."""
    block = [f"# TYPE {mname} summary"]
    for q in SUMMARY_QUANTILES:
        v = _fmt(float(var.latency_percentile(q)))
        block.append(f'{mname}{{quantile="{escape_label_value(repr(q))}"}} {v}')
    total = var.latency_sum()
    block.append(f"{mname}_sum {_fmt(total if isinstance(total, int) else float(total))}")
    block.append(f"{mname}_count {_fmt(int(var.count()))}")
    block.append(f"# TYPE {mname}_max_latency gauge")
    block.append(f"{mname}_max_latency {_fmt(float(var.max_latency()))}")
    block.append(f"# TYPE {mname}_qps gauge")
    block.append(f"{mname}_qps {_fmt(float(var.qps()))}")
    out.extend(block)


def _emit_simple(out: List[str], mname: str, mtype: str, value) -> None:
    v = _fmt(value)
    if v is None:
        return  # non-numeric bvar: nothing Prometheus can carry
    out.append(f"# TYPE {mname} {mtype}")
    out.append(f"{mname} {v}")


def render_metrics(prefix: str = "") -> str:
    """The whole exposition: one pass over the expose registry (plus the
    numeric flag mirror), sorted by name so scrapes are deterministic.
    ``prefix`` filters on the bvar (pre-sanitize) name, like /vars."""
    run_scrape_hooks()
    out: List[str] = []
    for name, var in expose_registry.snapshot(prefix):
        mname = sanitize_metric_name(name)
        if isinstance(var, LatencyRecorder) or hasattr(
            var, "latency_percentile"
        ):
            try:
                _emit_summary(out, mname, var)
            except Exception:
                continue  # a half-built recorder must not kill the scrape
            continue
        try:
            value = var.get_value()
        except Exception:
            continue
        if isinstance(var, Adder):
            _emit_simple(out, mname, "counter", value)
        elif isinstance(var, (Window, PassiveStatus, IntRecorder, Maxer, Miner)):
            _emit_simple(out, mname, "gauge", value)
        else:
            # unknown Variable subclass: expose numeric values as gauges
            _emit_simple(out, mname, "gauge", value)
    from incubator_brpc_tpu_torch.utils.flags import flag_registry

    for name, flag in flag_registry.items():
        row = f"flag_{name}"
        if prefix and not row.startswith(prefix):
            continue
        _emit_simple(out, sanitize_metric_name(row), "gauge", flag.value)
    return "\n".join(out) + ("\n" if out else "")

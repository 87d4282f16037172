"""Pull-based metric exporters: Prometheus text + JSON renderers.

The reference delegates exposition to whatever Dropwizard reporter the
host app wires up (KafkaProtoParquetWriter.java:144-151 only registers);
this module is the rebuild's equivalent seam, kept dependency-free: a
scrape endpoint calls :func:`registry_to_prometheus` (Prometheus
text-exposition format 0.0.4) or :func:`registry_to_json` on whatever
cadence it likes — nothing here runs a server or a thread, and gauges
backed by callables are sampled only at render time.

Both renderers are generic over the registry, so every canonical metric a
writer registers — including the degraded-operation set (the
``parquet.writer.stalled`` meter, the ``parquet.writer.paused`` gauge, and
the failover composite's ``parquet.writer.spilled`` /
``parquet.writer.reconciled`` / ``parquet.writer.reconcile.failed``
meters) — shows up in both formats with no per-metric wiring (pinned by
``test_degraded_metrics_render_in_exporters``).
"""

from __future__ import annotations

import json
import re

from .metrics import Gauge, Histogram, Meter

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LEAD = re.compile(r"^[^a-zA-Z_:]")


def prometheus_name(name: str) -> str:
    """Dotted metric name -> Prometheus metric name (`[a-zA-Z_:][a-zA-Z0-9_:]*`):
    ``parquet.writer.written.records`` -> ``parquet_writer_written_records``."""
    out = _PROM_BAD.sub("_", name)
    if _PROM_LEAD.match(out):
        out = "_" + out
    return out


def _num(v: float) -> str:
    """Prometheus sample value: repr-roundtrippable, NaN spelled ``NaN``."""
    if v != v:  # NaN (a dead gauge provider)
        return "NaN"
    return f"{v:.10g}"


def registry_to_json(registry) -> dict:
    """One JSON-serializable snapshot of every registered metric, keyed by
    its canonical (dotted) name, with a ``type`` discriminator per entry."""
    out: dict = {}
    for name in registry.names():
        m = registry.get(name)
        if isinstance(m, Meter):
            out[name] = {"type": "meter", **m.snapshot()}
        elif isinstance(m, Histogram):
            out[name] = {"type": "histogram", **m.snapshot()}
        elif isinstance(m, Gauge):
            v = m.value
            # NaN (a dead provider) is not valid RFC JSON — null instead,
            # so one broken gauge can't invalidate the whole document
            out[name] = {"type": "gauge", "value": None if v != v else v}
        else:  # a foreign metric object: expose what it shows
            out[name] = {"type": type(m).__name__}
    return out


def registry_to_json_str(registry, **dumps_kwargs) -> str:
    return json.dumps(registry_to_json(registry), **dumps_kwargs)


def registry_to_prometheus(registry) -> str:
    """Prometheus text-exposition rendering:

    - Meter  -> ``<name>_total`` counter + ``<name>_rate{window=...}``
      gauges (1m/5m/15m EWMAs + lifetime mean, events/second)
    - Histogram -> ``<name>`` summary (p50/p95/p99 quantile samples +
      ``_count``) and ``<name>_min``/``_max``/``_mean`` gauges
    - Gauge  -> plain gauge (callable-backed gauges sampled now; a raising
      provider renders ``NaN`` rather than failing the scrape)
    """
    lines: list[str] = []
    for name in registry.names():
        m = registry.get(name)
        pname = prometheus_name(name)
        if isinstance(m, Meter):
            s = m.snapshot()
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {s['count']}")
            lines.append(f"# TYPE {pname}_rate gauge")
            for window, key in (("1m", "m1_rate"), ("5m", "m5_rate"),
                                ("15m", "m15_rate"), ("mean", "mean_rate")):
                lines.append(
                    f'{pname}_rate{{window="{window}"}} {_num(s[key])}')
        elif isinstance(m, Histogram):
            s = m.snapshot()
            lines.append(f"# TYPE {pname} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                lines.append(f'{pname}{{quantile="{q}"}} {_num(s[key])}')
            lines.append(f"{pname}_count {s['count']}")
            for suffix in ("min", "max", "mean"):
                lines.append(f"# TYPE {pname}_{suffix} gauge")
                lines.append(f"{pname}_{suffix} {_num(s[suffix])}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_num(m.value)}")
    return "\n".join(lines) + "\n"

"""``repro_torch.obs`` — copies of the reference's tracer, metrics registry
and stats renderer (``repro.obs``). The Chrome-trace exporter and the
``check`` CLI are not ported yet: ROADMAP.md queue 1 item 9."""
from repro_torch.obs.metrics import (METRICS_SCHEMA, METRICS_VERSION,  # noqa: F401
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry, metric_scalar)
from repro_torch.obs.render import format_stats  # noqa: F401
from repro_torch.obs.trace import NULL_TRACER, Event, Tracer  # noqa: F401

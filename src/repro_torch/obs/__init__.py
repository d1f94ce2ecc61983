"""``repro_torch.obs`` — copies of the reference's observability substrate
(``repro.obs``): the tracer, the metrics registry, the stats renderer, the
Chrome trace-event exporter and ``python -m repro_torch.obs
summarize|diff|check`` over its artifacts, with the reference's schemas."""
from repro_torch.obs.export import (TRACE_SCHEMA, TRACE_VERSION,  # noqa: F401
                                    chrome_trace, load_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (METRICS_SCHEMA, METRICS_VERSION,  # noqa: F401
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry, load_snapshot,
                                     metric_scalar)
from repro_torch.obs.render import format_stats  # noqa: F401
from repro_torch.obs.trace import NULL_TRACER, Event, Tracer  # noqa: F401

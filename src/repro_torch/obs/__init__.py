"""Emerald observability: tracing, metrics, event schema, introspection.

``obs`` is stdlib-only and import-light so any layer (driver, broker
reader threads, scripts) can use it; worker child processes never import
it — they report raw phase timings in the reply frame and the broker
re-materialises those as spans driver-side.
"""
from repro_torch.obs.events import EVENT_SCHEMA, validate_event
from repro_torch.obs.introspect import render
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.tracing import Span, Tracer, chrome_trace, wall_now, wall_of

__all__ = [
    "EVENT_SCHEMA", "validate_event", "render",
    "REGISTRY", "MetricsRegistry",
    "Span", "Tracer", "chrome_trace", "wall_now", "wall_of",
]

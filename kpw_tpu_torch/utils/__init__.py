"""Cross-cutting utilities: tracing/profiling (SURVEY.md §5)."""

from .tracing import (  # noqa: F401
    STAGE_NAMES,
    SpanRecorder,
    StageTimer,
    get_span_recorder,
    get_tracer,
    set_span_recorder,
    set_tracer,
    stage,
)

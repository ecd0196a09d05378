# Observability: span tracing, metrics registry and time series.

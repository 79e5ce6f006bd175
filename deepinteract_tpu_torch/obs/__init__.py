"""Host-side telemetry: metrics registry, phase spans, heartbeats."""

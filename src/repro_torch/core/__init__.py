"""Reliability core: rail model, fault field, telemetry, plane arena and the
DED-canary controllers."""

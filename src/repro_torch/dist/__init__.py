"""Distributed substrate of the port (``repro.dist``): the one-host
checkpoint manager and the fault-tolerance layer (KV stores, heartbeats,
elastic mesh plans). Sharding contexts and the compressed collective are
ROADMAP.md queue 1 item 14."""

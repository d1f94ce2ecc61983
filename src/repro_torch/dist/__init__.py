"""Distributed substrate of the port (``repro.dist``): sharding rules and
their DTensor layouts, the int8 compressed collectives, the sharded
checkpoint manager and the fault-tolerance layer (KV stores, heartbeats,
elastic mesh plans)."""

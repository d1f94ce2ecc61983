"""Distributed substrate of the port (``repro.dist``): the one-host
checkpoint manager. Sharding contexts, fault tolerance and the compressed
collective are ROADMAP.md queue 1 item 14."""

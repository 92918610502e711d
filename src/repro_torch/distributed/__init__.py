"""Distributed training.  Only ``fault`` (heartbeats, straggler detection,
restarts) is ported; meshes, sharding and collectives wait for ROADMAP.md's
queue 1, item 12."""

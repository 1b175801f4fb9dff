"""Multi-device placement (twin of ``repro.distributed``). This slice holds
:mod:`.expert_placement`; the mesh modules (counters, halo, placement,
sharding) come with the port's multi-device slice (ROADMAP, queue A item 10)."""

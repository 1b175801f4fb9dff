"""Multi-device placement (twin of ``repro.distributed``): the per-vertex
counter reduction of the sharded replay (:mod:`.counters`), partition-aware
placement (:mod:`.placement`), the halo exchange (:mod:`.halo`), MoE
expert placement (:mod:`.expert_placement`) and the sharding rules of the
model families (:mod:`.sharding`)."""

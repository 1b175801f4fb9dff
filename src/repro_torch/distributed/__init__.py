"""Multi-device placement (twin of ``repro.distributed``): the per-vertex
counter reduction of the sharded replay (:mod:`.counters`), partition-aware
placement (:mod:`.placement`), the halo exchange (:mod:`.halo`) and MoE
expert placement (:mod:`.expert_placement`). The model-sharding rules wait
for the model side of the multi-device work."""

"""Parallelism over ``torch.distributed``: int8 gradient compression, the
sharding rules and their DTensor placements, tensor and expert parallelism
on a model's shards (``tensor``), the hierarchical reduction and the GPipe
pipeline.

Port of ``repro.parallel``. The JAX package runs these inside ``shard_map``
over named mesh axes; here each mesh axis is a process group of a
``DeviceMesh`` (``repro_torch.launch.mesh``), and every rank runs the same
code on its own shard, one process a device.
"""

"""The paper's explicit distribution techniques (``repro.core``): weight-
update sharding (C1, :mod:`.weight_update_sharding`), 2-D gradient
summation (C2, :mod:`.gradient_summation`), spatial and sequence
partitioning (C3, :mod:`.spatial_partitioning`), the padded, masked eval
(C4, :mod:`.distributed_eval`), distributed batch norm (C5,
:mod:`.distributed_norm`) and graph partitioning (C10,
:mod:`.graph_partitioning`). Each runs once per rank of a
``launch.mesh.Mesh`` on that rank's tensors; batch norm and graph
partitioning also run without a mesh, on one device."""

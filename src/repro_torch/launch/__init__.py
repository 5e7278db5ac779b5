"""Command-line entry points of the port."""

# The production meshes the dry run sizes a rank's steps on
# (``launch.mesh.production_mesh_shape``): 16 x 16 on one pod, 2 x 16 x
# 16 over two.
POD_DEVICES = 256
MULTIPOD_DEVICES = 512

# The runtime of the port (counterpart of repro.runtime): checkpointing
# (checkpoint.py, the serve layer's write-ahead journal, restored onto a
# mesh with shardings=), heartbeats, the host scan and failure injection
# (monitor.py), and elastic meshes (elastic.py: shrink_mesh,
# reshard_array).

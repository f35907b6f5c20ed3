# The runtime of the port (counterpart of repro.runtime): checkpointing
# (checkpoint.py, the serve layer's write-ahead journal), heartbeats, the
# host scan and failure injection (monitor.py).  Elastic meshes
# (runtime/elastic.py) wait for the distributed port (ROADMAP queue 1 item 10).

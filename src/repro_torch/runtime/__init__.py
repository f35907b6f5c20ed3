# The runtime of the port (counterpart of repro.runtime): so far only the
# failure-injection classes of monitor.py that the chaos harness builds on.
# Heartbeat, scan_hosts, checkpointing and elastic meshes come with the
# serve port (ROADMAP queue 1 item 11).

"""The PsPIN simulator side of the port: workload cost models, packet
traces, per-tenant statistics and the device sweep datapath
(``sim/devicepath.py``)."""

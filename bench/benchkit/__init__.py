"""The benchmark's own code: the registry of cells, configurations, traffic
mixes and metrics, the traffic generator, the yardstick (peaks, request
statistics), the energy meter, the device-trace reduction and the harness
that runs one cell once.  Nothing here imports the program under test;
`systems/` adapts it, `configs/` holds each configuration and its plain
reference."""

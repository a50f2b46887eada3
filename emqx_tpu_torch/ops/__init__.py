"""Device ops of the port: the walk, pack, fan-out and bitmap OR."""

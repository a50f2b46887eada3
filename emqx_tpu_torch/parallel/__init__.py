"""Multi-device operation: device meshes, sharded automatons and the
collective publish step (the reference's cluster routing layer mapped
onto a grid of torch devices)."""

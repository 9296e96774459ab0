"""Control-plane pieces the port's serving path needs: hardware menu,
pipeline spec and the measured profiler (copies of the reference's)."""

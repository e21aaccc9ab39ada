"""Ray generation, encoding, sampling, compositing and occupancy culling."""

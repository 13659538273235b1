"""The harness: inputs drawn from the seed, the cells' set-up, window and
readings, the comparison that decides ``correct``, the reduction of the
profiler's trace and the frozen yardstick."""

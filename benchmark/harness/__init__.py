"""The benchmark's own code: inputs, trace reduction, the yardstick."""

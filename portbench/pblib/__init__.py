"""The benchmark's own library: the yardstick that later changes to the
program cannot move (traffic, meshes, the bound arithmetic, the comparison
with the reference, the reading of traces)."""

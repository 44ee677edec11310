"""The device-grid layer: the 2D/3D box decomposition of the Kronecker
family (`grid2d`), with every shard stacked on one device."""

"""File formats (.xyz, KITTI .bin, .mm.npz, the reference's binary .mm, .rawlog.npz) and ICP log records: the port's copies of the JAX package's io modules."""

"""Fixed-order segment sum: the port's float scatter-adds in one launch."""

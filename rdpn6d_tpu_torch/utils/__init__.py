"""Device resolution and the flax-tree weight carrier."""

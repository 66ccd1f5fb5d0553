"""ROI warp, resizes, region gather, coordinate bins, and the CUDA kernels
(``min_dist``) with their plain PyTorch versions."""

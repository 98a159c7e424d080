"""Image pyramids, gradients and bilinear sampling."""

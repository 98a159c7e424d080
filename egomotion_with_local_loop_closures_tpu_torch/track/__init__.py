"""Multi-scale Gauss-Newton direct image alignment."""

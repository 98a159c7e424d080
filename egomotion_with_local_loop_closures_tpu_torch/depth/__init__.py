"""The inverse-depth filter: state, stereo, propagation, regularization."""

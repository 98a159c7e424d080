"""Local loop closure: image histograms and the keyframe-window closer."""

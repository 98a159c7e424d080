"""se(3)/SO(3) Lie operations, the pinhole camera and small SPD solves."""

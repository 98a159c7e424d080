"""The frame-loop pipeline, the sequence runner, pose IO and the CLI."""

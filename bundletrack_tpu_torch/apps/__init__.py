"""Command-line apps: track a sequence from a config, score the poses."""

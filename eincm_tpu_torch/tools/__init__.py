"""Command-line tools: the DSEC benchmark submission and extended evals."""

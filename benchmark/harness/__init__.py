"""The harness: the data it reads, the generators, the timeline, the check."""

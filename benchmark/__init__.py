"""The benchmark of octree_pathtracing_tpu_torch: see PERF.md and run.py."""

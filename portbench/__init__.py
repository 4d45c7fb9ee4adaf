"""The benchmark of bwamem2_tpu_torch: `python3 portbench/run.py --help`."""

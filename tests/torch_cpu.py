"""Imported by every CPU test file of the port: one intra-op torch thread
a test process.

The port's CPU tests run tiny shapes, which more threads do not speed
up, while the suite runs several xdist workers on the machine's cores at
once: with torch's default of a thread a core, each worker's OpenMP team
spins on cores the other workers need, and every worker slows down many
times over.  The ranks that ``torch_dist_workers.spawn`` starts set the
same in their own processes.
"""
import torch

torch.set_num_threads(1)

"""C4P, the communication half of C4: path probing, path allocation, dynamic
load balancing and the master over them. Copies of ``repro.core.c4p``'s
NumPy modules."""

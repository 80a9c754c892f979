"""The host's C++ kernels (g++, ctypes): the edge filters and event ingest."""

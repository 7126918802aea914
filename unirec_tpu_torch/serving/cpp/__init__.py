"""The C++ serving client: unirec_serve.cc, its build (build.py) and its tensor files (tensor_io.py)."""

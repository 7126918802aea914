"""Serving: torch.export artifacts and the C++ client (serving/cpp)."""

"""The model zoo of the port (dense decoder LMs so far)."""

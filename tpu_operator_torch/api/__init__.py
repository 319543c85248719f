"""Resource names and labels of the port."""

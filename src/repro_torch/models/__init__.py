"""Models of the port (the paper's prototype CNN and the MLP classifier)."""

"""Models of the port: attention-dense LMs (GQA) for the serve path."""

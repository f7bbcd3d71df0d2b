"""Models of the port: the flagship GPT (single device) and its decode."""

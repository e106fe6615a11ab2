"""Multi-frame layer of the port (single process for now): all-pairs
covisibility scores."""

"""One driver per kind of traffic (``"driver"`` of a traffic file)."""

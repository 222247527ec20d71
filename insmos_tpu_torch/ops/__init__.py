"""Box geometry, NMS and point-in-box ops."""

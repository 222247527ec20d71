"""Box geometry and IoU, NMS, point-in-box ops and gaussian heatmap targets."""

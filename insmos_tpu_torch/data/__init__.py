"""Input data (numpy): the HDL-64E raycast fixture, the KITTI file helpers,
the scan prefetcher and synthetic KITTI-format sequences."""

"""Robot I/O and recorded demos (PLY and PNG files, keyframes, calibration,
ReplaySource), the kitchen writer and its manifests, the native PLY loader,
and the synthetic scene (numpy only, but for the text tower the writer runs)."""

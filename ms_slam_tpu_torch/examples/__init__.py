"""Command-line drivers of the port, run as modules:

    python -m ms_slam_tpu_torch.examples.stereo_kitti SETTINGS SEQ_DIR
    python -m ms_slam_tpu_torch.examples.stereo_euroc SETTINGS MAV0_DIR
    python -m ms_slam_tpu_torch.examples.stereo_inertial_euroc SETTINGS MAV0
    python -m ms_slam_tpu_torch.examples.stereo_inertial_4season SETTINGS SEQ
    python -m ms_slam_tpu_torch.examples.evaluate_ate GT.txt EST.txt
    python -m ms_slam_tpu_torch.examples.gen_fake_euroc [OUT_DIR]

Each keeps the arguments and the printed report of the reference's driver of
the same name in `examples/`, and adds `--device` (default `cuda`; `cpu`
only on request). Each driver's loop is a function, `run(slam, frames, n)`,
that takes a built System and a stream of `utils.datasets.StereoFrame`s;
`main(argv)` parses the arguments, builds the settings, the System and the
dataset, and calls it.
"""

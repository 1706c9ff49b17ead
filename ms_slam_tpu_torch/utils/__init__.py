"""Host utilities of the port, each its own copy or port of the reference's
module of the same name: settings files (`config`), map checkpoints
(`checkpoint`), dataset readers (`datasets`) on the native decode/rectify
prefetch runtime (`native`), the headless viewer (`viewer`), rendered test
worlds (`synth`) and trajectory evaluation (`evaluate`); and the port's own
host spans and sync counts (`trace`)."""

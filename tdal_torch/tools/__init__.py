"""The port's command-line entry points, one module a stage, each mirroring its
``tools/`` file's arguments and output files: ``python -m tdal_torch.tools.<stage>``
(``train``, ``dist_test``, ``waymo_tracking.test``, ``trackData``, ``trackGT``,
``motionState``, ``static_train``, ``static_eval``, ``dynamic_train``,
``dynamic_eval``). Each takes ``--device`` (default: CUDA, which raises without a
card; ``--device cpu`` runs the plain versions on the CPU)."""

"""The port's command-line entry points, one module a stage, each mirroring its
``tools/`` file's arguments and output files: ``python -m tdal_torch.tools.<stage>``
(``create_data``, ``train``, ``dist_test``, ``waymo_tracking.test``,
``waymo_tracking.line_search``, ``trackData``, ``trackGT``, ``motionState``,
``static_init``, ``static_train``, ``static_eval``, ``dynamic_init``,
``dynamic_train``, ``dynamic_eval``, ``eval``, ``visualize.vis_data``,
``visualize.vis_track``, ``visualize.vis_pred``). Each that runs torch work takes
``--device`` (default: CUDA, which raises without a card; ``--device cpu`` runs the
plain versions on the CPU); ``create_data``, ``line_search``, ``trackData``,
``trackGT``, ``motionState`` and the three ``visualize`` tools are host work and take
none. ``dist_test --checkpoint``, ``static_eval`` / ``dynamic_eval --model_path``,
``train --resume_from`` and a config's ``first_stage_cfg.pretrained`` also take a
checkpoint directory that ``tdal`` wrote."""

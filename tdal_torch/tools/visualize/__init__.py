"""The visualisation CLIs, ports of ``tools/visualize/``: ``vis_data``, ``vis_track``
and ``vis_pred``."""

"""A narrow PointPillars over the synthetic scenes: the detector of the committed tdal
checkpoint fixture (written by ``make_fixture.py`` beside this file). One task, 8
filters, one RPN stage of stride 1 (two 3x3 FusedConvBN sites), a 16 x 16 BEV grid.
``fixture_frames`` are the ``make_synthetic_dataset`` arguments of the fixture's two
frames."""

tasks = [dict(num_class=1, class_names=["VEHICLE"])]
class_names = ["VEHICLE"]
pc_range = [3.2, -12.8, -2.0, 28.8, 12.8, 4.0]

model = dict(
    type="PointPillars",
    reader=dict(type="PillarFeatureNet", num_filters=[8], voxel_size=(1.6, 1.6, 6.0),
                pc_range=tuple(pc_range)),
    backbone=dict(type="PointPillarsScatter", ds_factor=1),
    neck=dict(type="RPN", layer_nums=[1], ds_layer_strides=[1], ds_num_filters=[8],
              us_layer_strides=[1], us_num_filters=[8]),
    bbox_head=dict(type="CenterHead", tasks=tasks, dataset="waymo", weight=2,
                   code_weights=[1.0] * 8,
                   common_heads={"reg": (2, 2), "height": (1, 2), "dim": (3, 2),
                                 "rot": (2, 2)}),
)

assigner = dict(target_assigner=dict(tasks=tasks), out_size_factor=1, gaussian_overlap=0.1,
                max_objs=50, min_radius=2)
train_cfg = dict(assigner=assigner)

test_cfg = dict(
    post_center_limit_range=[0.0, -16.0, -10.0, 32.0, 16.0, 10.0],
    nms=dict(nms_pre_max_size=64, nms_post_max_size=16, nms_iou_threshold=0.7),
    score_threshold=0.1,
    pc_range=pc_range[:2],
    out_size_factor=1,
    voxel_size=[1.6, 1.6],
)

voxel_generator = dict(range=pc_range, voxel_size=[1.6, 1.6, 6.0], max_points_in_voxel=20,
                       max_voxel_num=[256, 256])

train_preprocessor = dict(mode="train", shuffle_points=True,
                          global_rot_noise=[-0.78539816, 0.78539816],
                          global_scale_noise=[0.95, 1.05], class_names=class_names)

data = dict(
    samples_per_gpu=2,
    train=dict(info_path="", nsweeps=1, class_names=class_names, max_points=4096),
    val=dict(info_path="", nsweeps=1, class_names=class_names, max_points=4096,
             test_mode=True),
)

optimizer = dict(type="adam", wd=0.01)
lr_config = dict(type="one_cycle", lr_max=3e-3, moms=[0.95, 0.85], div_factor=10.0,
                 pct_start=0.4)
grad_clip = dict(max_norm=35)
total_epochs = 1
work_dir = "./work_dirs/pp_narrow"
fixture_frames = dict(n_scenes=1, n_frames=2, seed=13, n_static=3, n_dynamic=2,
                      points_per_object=64, n_background=1500)

from .skeleton3d import animate_skeletons
from .keypoints2d import render_keypoint_video
from .physics_viz import animate_physics_results
from .plots import plot_train_curves, plot_confusion_matrix, plot_3curve

from .instance import (find_instance_centers, group_pixels,
                       get_instance_segmentation_and_centers,
                       make_instance_id_temporally_consistent,
                       predict_instance_segmentation_and_trajectories)

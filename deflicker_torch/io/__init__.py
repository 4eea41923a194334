from .media import (FlowCache, frames_to_video, imresize, list_frames,
                    read_image, video_to_frames, write_image)

from .flow_io import (flow_to_image, read_flo, read_kitti_flow, read_pfm,
                      write_flo, write_kitti_flow, write_pfm)

__all__ = ["video_to_frames", "frames_to_video", "read_image", "write_image",
           "list_frames", "FlowCache", "imresize", "read_flo", "write_flo",
           "read_kitti_flow", "write_kitti_flow", "read_pfm", "write_pfm",
           "flow_to_image"]

from .media import (FlowCache, frames_to_video, imresize, list_frames,
                    read_image, video_to_frames, write_image)

__all__ = ["video_to_frames", "frames_to_video", "read_image", "write_image",
           "list_frames", "FlowCache", "imresize"]

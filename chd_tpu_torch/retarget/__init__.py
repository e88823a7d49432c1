from .mixamo import retarget, softmax, softmin

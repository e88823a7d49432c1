from .infer import ContactDetector, detect_contacts

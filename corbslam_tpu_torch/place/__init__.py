"""Place recognition: BoW vocabulary and keyframe database."""

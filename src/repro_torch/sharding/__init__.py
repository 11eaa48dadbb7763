from repro_torch.sharding.ctx import (  # noqa: F401
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    current_rules,
    shard_activation,
    use_sharding_rules,
)

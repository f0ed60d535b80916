# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: scheduler.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fscheduler.proto\x12\x07smg_tpu"\xd9\x03\n\x13SamplingParamsProto\x12\x16\n\x0emax_new_tokens\x18\x01 \x01(\r\x12\x13\n\x0btemperature\x18\x02 \x01(\x02\x12\r\n\x05top_p\x18\x03 \x01(\x02\x12\r\n\x05top_k\x18\x04 \x01(\x05\x12\r\n\x05min_p\x18\x05 \x01(\x02\x12\x19\n\x11frequency_penalty\x18\x06 \x01(\x02\x12\x18\n\x10presence_penalty\x18\x07 \x01(\x02\x12\x1a\n\x12repetition_penalty\x18\x08 \x01(\x02\x12\x16\n\x0estop_token_ids\x18\t \x03(\r\x12\x12\n\nignore_eos\x18\n \x01(\x08\x12\x11\n\x04seed\x18\x0b \x01(\x04H\x00\x88\x01\x01\x12\t\n\x01n\x18\x0c \x01(\r\x12\x10\n\x08logprobs\x18\r \x01(\x08\x12\x14\n\x0ctop_logprobs\x18\x0e \x01(\r\x12\x0c\n\x04stop\x18\x0f \x03(\t\x12\x18\n\x0bjson_schema\x18\x10 \x01(\tH\x01\x88\x01\x01\x12\x12\n\x05regex\x18\x11 \x01(\tH\x02\x88\x01\x01\x12\x11\n\x04ebnf\x18\x12 \x01(\tH\x03\x88\x01\x01\x12\x19\n\x0clora_adapter\x18\x13 \x01(\tH\x04\x88\x01\x01B\x07\n\x05_seedB\x0e\n\x0c_json_schemaB\x08\n\x06_regexB\x07\n\x05_ebnfB\x0f\n\r_lora_adapter"p\n\rMmEmbedsProto\x12\x0e\n\x06embeds\x18\x01 \x01(\x0c\x12\x0c\n\x04rows\x18\x02 \x01(\r\x12\x0c\n\x04cols\x18\x03 \x01(\r\x12\x11\n\tpositions\x18\x04 \x03(\r\x12\x0f\n\x07grid_hs\x18\x05 \x03(\r\x12\x0f\n\x07grid_ws\x18\x06 \x03(\r"\xd5\x01\n\x14GenerateRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\x11\n\tinput_ids\x18\x02 \x03(\r\x12.\n\x08sampling\x18\x03 \x01(\x0b2\x1c.smg_tpu.SamplingParamsProto\x12\x10\n\x08priority\x18\x04 \x01(\x05\x12\x1a\n\x12data_parallel_rank\x18\x05 \x01(\x11\x12)\n\tmm_embeds\x18\x06 \x01(\x0b2\x16.smg_tpu.MmEmbedsProto\x12\x14\n\x0ctimeout_secs\x18\x07 \x01(\x02"\xda\x01\n\rGenerateChunk\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\x11\n\ttoken_ids\x18\x02 \x03(\r\x12\x10\n\x08logprobs\x18\x03 \x03(\x02\x12\x10\n\x08finished\x18\x04 \x01(\x08\x12\x15\n\rfinish_reason\x18\x05 \x01(\t\x12\x1a\n\x12matched_stop_token\x18\x06 \x01(\x12\x12\x15\n\rprompt_tokens\x18\x07 \x01(\r\x12\x15\n\rcached_tokens\x18\x08 \x01(\r\x12\x15\n\routput_tokens\x18\t \x01(\r\x12\r\n\x05error\x18\n \x01(\t" \n\x11AbortRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t" \n\x12AbortResponseProto\x12\n\n\x02ok\x18\x01 \x01(\x08"\x0c\n\nEmptyProto"!\n\x13HealthResponseProto\x12\n\n\x02ok\x18\x01 \x01(\x08"\x8f\x01\n\nLoadsProto\x12\x13\n\x0bnum_waiting\x18\x01 \x01(\r\x12\x13\n\x0bnum_running\x18\x02 \x01(\r\x12\x12\n\nfree_pages\x18\x03 \x01(\r\x12\x14\n\x0ccached_pages\x18\x04 \x01(\r\x12\x13\n\x0btotal_pages\x18\x05 \x01(\r\x12\x18\n\x10dp_queued_tokens\x18\x06 \x03(\x04"\x8b\x02\n\x0eModelInfoProto\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x13\n\x0bmax_seq_len\x18\x02 \x01(\r\x12\x12\n\nvocab_size\x18\x03 \x01(\r\x12\x15\n\reos_token_ids\x18\x04 \x03(\r\x12\x11\n\tpage_size\x18\x05 \x01(\r\x12\x0f\n\x07dp_size\x18\x06 \x01(\r\x12\x17\n\x0fsupports_vision\x18\x07 \x01(\x08\x12\x16\n\x0eimage_token_id\x18\x08 \x01(\r\x12\x19\n\x11vision_patch_size\x18\t \x01(\r\x12\x19\n\x11vision_merge_size\x18\n \x01(\r\x12\x1c\n\x14supports_kv_transfer\x18\x0b \x01(\x08" \n\x12FlushResponseProto\x12\n\n\x02ok\x18\x01 \x01(\x08"m\n\x18StartProfileRequestProto\x12\x12\n\noutput_dir\x18\x01 \x01(\t\x12\x11\n\tnum_steps\x18\x02 \x01(\r\x12\x13\n\x0bhost_tracer\x18\x03 \x01(\x08\x12\x15\n\rpython_tracer\x18\x04 \x01(\x08"E\n\x14ProfileResponseProto\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05error\x18\x02 \x01(\t\x12\x12\n\noutput_dir\x18\x03 \x01(\t"?\n\x14LoadLoraRequestProto\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04path\x18\x02 \x01(\t\x12\x0b\n\x03npz\x18\x03 \x01(\x0c">\n\x13LoraOpResponseProto\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\r\n\x05error\x18\x02 \x01(\t\x12\x0c\n\x04slot\x18\x03 \x01(\r"\x1e\n\rLoraListProto\x12\r\n\x05names\x18\x01 \x03(\t"Q\n\x13TokenizerChunkProto\x12\x0c\n\x04data\x18\x01 \x01(\x0c\x12\x0c\n\x04last\x18\x02 \x01(\x08\x12\x0e\n\x06sha256\x18\x03 \x01(\t\x12\x0e\n\x06format\x18\x04 \x01(\t"5\n\x14KvEventsRequestProto\x12\x1d\n\x15start_sequence_number\x18\x01 \x01(\x04"\x85\x01\n\x10BlockStoredProto\x12\x14\n\x0cblock_hashes\x18\x01 \x03(\x04\x12\x11\n\ttoken_ids\x18\x02 \x03(\r\x12\x1e\n\x11parent_block_hash\x18\x03 \x01(\x04H\x00\x88\x01\x01\x12\x12\n\nblock_size\x18\x04 \x01(\rB\x14\n\x12_parent_block_hash")\n\x11BlockRemovedProto\x12\x14\n\x0cblock_hashes\x18\x01 \x03(\x04"\x8a\x01\n\x0cKvEventProto\x12+\n\x06stored\x18\x01 \x01(\x0b2\x19.smg_tpu.BlockStoredProtoH\x00\x12-\n\x07removed\x18\x02 \x01(\x0b2\x1a.smg_tpu.BlockRemovedProtoH\x00\x12\x15\n\x0ball_cleared\x18\x03 \x01(\x08H\x00B\x07\n\x05event"d\n\x11KvEventBatchProto\x12\x17\n\x0fsequence_number\x18\x01 \x01(\x04\x12%\n\x06events\x18\x02 \x03(\x0b2\x15.smg_tpu.KvEventProto\x12\x0f\n\x07dp_rank\x18\x03 \x01(\r"3\n\x11EmbedRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\x11\n\tinput_ids\x18\x02 \x03(\r"M\n\x12EmbedResponseProto\x12\x11\n\tembedding\x18\x01 \x03(\x02\x12\x15\n\rprompt_tokens\x18\x02 \x01(\r\x12\r\n\x05error\x18\x03 \x01(\t"\x1d\n\x0eTokenListProto\x12\x0b\n\x03ids\x18\x01 \x03(\r"N\n\x16EmbedBatchRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\'\n\x06inputs\x18\x02 \x03(\x0b2\x17.smg_tpu.TokenListProto"#\n\x11EmbeddingVecProto\x12\x0e\n\x06values\x18\x01 \x03(\x02"o\n\x17EmbedBatchResponseProto\x12.\n\nembeddings\x18\x01 \x03(\x0b2\x1a.smg_tpu.EmbeddingVecProto\x12\x15\n\rprompt_tokens\x18\x02 \x01(\r\x12\r\n\x05error\x18\x03 \x01(\t"~\n\x19PrefillExportRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\x11\n\tinput_ids\x18\x02 \x03(\r\x12.\n\x08sampling\x18\x03 \x01(\x0b2\x1c.smg_tpu.SamplingParamsProto\x12\x11\n\tconnector\x18\x04 \x01(\t"\xbc\x01\n\x1aPrefillExportResponseProto\x12\x13\n\x0bfirst_token\x18\x01 \x01(\r\x12\x0f\n\x07seq_len\x18\x02 \x01(\r\x12\t\n\x01k\x18\x03 \x01(\x0c\x12\t\n\x01v\x18\x04 \x01(\x0c\x12\x10\n\x08kv_shape\x18\x05 \x03(\r\x12\x10\n\x08kv_dtype\x18\x06 \x01(\t\x12\r\n\x05error\x18\x07 \x01(\t\x12\x18\n\x10transfer_address\x18\x08 \x01(\t\x12\x15\n\rtransfer_uuid\x18\t \x01(\x04"\xcc\x01\n\x1dGeneratePrefilledRequestProto\x12+\n\x04base\x18\x01 \x01(\x0b2\x1d.smg_tpu.GenerateRequestProto\x12\x13\n\x0bfirst_token\x18\x02 \x01(\r\x12\t\n\x01k\x18\x03 \x01(\x0c\x12\t\n\x01v\x18\x04 \x01(\x0c\x12\x10\n\x08kv_shape\x18\x05 \x03(\r\x12\x10\n\x08kv_dtype\x18\x06 \x01(\t\x12\x18\n\x10transfer_address\x18\x07 \x01(\t\x12\x15\n\rtransfer_uuid\x18\x08 \x01(\x04".\n\x0cKvOfferProto\x12\x0c\n\x04uuid\x18\x01 \x01(\x04\x12\x10\n\x08consumed\x18\x02 \x01(\x08"\x8f\x01\n\x12EncodeRequestProto\x12\x0b\n\x03rid\x18\x01 \x01(\t\x12\x14\n\x0cpixel_values\x18\x02 \x01(\x0c\x12\x11\n\tn_patches\x18\x03 \x01(\r\x12\x11\n\tpatch_dim\x18\x04 \x01(\r\x12\x0e\n\x06grid_h\x18\x05 \x01(\r\x12\x0e\n\x06grid_w\x18\x06 \x01(\r\x12\x10\n\x08shm_name\x18\x07 \x01(\t"P\n\x13EncodeResponseProto\x12\x0e\n\x06embeds\x18\x01 \x01(\x0c\x12\x0c\n\x04rows\x18\x02 \x01(\r\x12\x0c\n\x04cols\x18\x03 \x01(\r\x12\r\n\x05error\x18\x04 \x01(\t"(\n\x16FlightDumpRequestProto\x12\x0e\n\x06reason\x18\x01 \x01(\t"6\n\x17FlightDumpResponseProto\x12\x0c\n\x04json\x18\x01 \x01(\t\x12\r\n\x05error\x18\x02 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'scheduler_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SAMPLINGPARAMSPROTO._serialized_start=29
  _SAMPLINGPARAMSPROTO._serialized_end=502
  _MMEMBEDSPROTO._serialized_start=504
  _MMEMBEDSPROTO._serialized_end=616
  _GENERATEREQUESTPROTO._serialized_start=619
  _GENERATEREQUESTPROTO._serialized_end=832
  _GENERATECHUNK._serialized_start=835
  _GENERATECHUNK._serialized_end=1053
  _ABORTREQUESTPROTO._serialized_start=1055
  _ABORTREQUESTPROTO._serialized_end=1087
  _ABORTRESPONSEPROTO._serialized_start=1089
  _ABORTRESPONSEPROTO._serialized_end=1121
  _EMPTYPROTO._serialized_start=1123
  _EMPTYPROTO._serialized_end=1135
  _HEALTHRESPONSEPROTO._serialized_start=1137
  _HEALTHRESPONSEPROTO._serialized_end=1170
  _LOADSPROTO._serialized_start=1173
  _LOADSPROTO._serialized_end=1316
  _MODELINFOPROTO._serialized_start=1319
  _MODELINFOPROTO._serialized_end=1586
  _FLUSHRESPONSEPROTO._serialized_start=1588
  _FLUSHRESPONSEPROTO._serialized_end=1620
  _STARTPROFILEREQUESTPROTO._serialized_start=1622
  _STARTPROFILEREQUESTPROTO._serialized_end=1731
  _PROFILERESPONSEPROTO._serialized_start=1733
  _PROFILERESPONSEPROTO._serialized_end=1802
  _LOADLORAREQUESTPROTO._serialized_start=1804
  _LOADLORAREQUESTPROTO._serialized_end=1867
  _LORAOPRESPONSEPROTO._serialized_start=1869
  _LORAOPRESPONSEPROTO._serialized_end=1931
  _LORALISTPROTO._serialized_start=1933
  _LORALISTPROTO._serialized_end=1963
  _TOKENIZERCHUNKPROTO._serialized_start=1965
  _TOKENIZERCHUNKPROTO._serialized_end=2046
  _KVEVENTSREQUESTPROTO._serialized_start=2048
  _KVEVENTSREQUESTPROTO._serialized_end=2101
  _BLOCKSTOREDPROTO._serialized_start=2104
  _BLOCKSTOREDPROTO._serialized_end=2237
  _BLOCKREMOVEDPROTO._serialized_start=2239
  _BLOCKREMOVEDPROTO._serialized_end=2280
  _KVEVENTPROTO._serialized_start=2283
  _KVEVENTPROTO._serialized_end=2421
  _KVEVENTBATCHPROTO._serialized_start=2423
  _KVEVENTBATCHPROTO._serialized_end=2523
  _EMBEDREQUESTPROTO._serialized_start=2525
  _EMBEDREQUESTPROTO._serialized_end=2576
  _EMBEDRESPONSEPROTO._serialized_start=2578
  _EMBEDRESPONSEPROTO._serialized_end=2655
  _TOKENLISTPROTO._serialized_start=2657
  _TOKENLISTPROTO._serialized_end=2686
  _EMBEDBATCHREQUESTPROTO._serialized_start=2688
  _EMBEDBATCHREQUESTPROTO._serialized_end=2766
  _EMBEDDINGVECPROTO._serialized_start=2768
  _EMBEDDINGVECPROTO._serialized_end=2803
  _EMBEDBATCHRESPONSEPROTO._serialized_start=2805
  _EMBEDBATCHRESPONSEPROTO._serialized_end=2916
  _PREFILLEXPORTREQUESTPROTO._serialized_start=2918
  _PREFILLEXPORTREQUESTPROTO._serialized_end=3044
  _PREFILLEXPORTRESPONSEPROTO._serialized_start=3047
  _PREFILLEXPORTRESPONSEPROTO._serialized_end=3235
  _GENERATEPREFILLEDREQUESTPROTO._serialized_start=3238
  _GENERATEPREFILLEDREQUESTPROTO._serialized_end=3442
  _KVOFFERPROTO._serialized_start=3444
  _KVOFFERPROTO._serialized_end=3490
  _ENCODEREQUESTPROTO._serialized_start=3493
  _ENCODEREQUESTPROTO._serialized_end=3636
  _ENCODERESPONSEPROTO._serialized_start=3638
  _ENCODERESPONSEPROTO._serialized_end=3718
  _FLIGHTDUMPREQUESTPROTO._serialized_start=3720
  _FLIGHTDUMPREQUESTPROTO._serialized_end=3760
  _FLIGHTDUMPRESPONSEPROTO._serialized_start=3762
  _FLIGHTDUMPRESPONSEPROTO._serialized_end=3816
# @@protoc_insertion_point(module_scope)
